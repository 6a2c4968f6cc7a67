"""The CSR scatter-add of the port (repro_torch.kernels.bloom_csr: the
binning and the plain version, kernels.ref.csr_scatter_add_ref) against the
JAX package's Pallas ``bloom_embed_bwd_csr_pallas`` run in interpret mode,
and the gradient of the port's ``ops.bloom_embed`` against ``jax.grad`` of
the reference's ``ops.bloom_embed`` (``bwd_impl="csr"``), on the same
numpy cotangents, tables and indices.

Tolerances: the scatter-add within 1e-5 absolute plus 1e-6 relative (a
row that collects every entry sums to tens), because the reference sums
each entry tile by a one-hot matmul whose order is the compiler's; the
port's plain version against its own oracle exactly (both add each row's
entries in token, then j, order from 0.0).  The embedding gradient within 1e-5 on
an f32 table and within one bf16 ulp on a bf16 table (the f32 sum rounded
once to the table's dtype on both sides).  Index sets with all entries in
a few rows and with rows no entry reaches are included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels.bloom_csr import bloom_embed_bwd_csr_pallas
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_csr as csr
from repro_torch.kernels import common, ops, ref

from test_torch_embed import _ulp_bf16

SHAPES = [(1, 1, 16, 32), (7, 3, 64, 48), (16, 4, 128, 256),
          (13, 4, 96, 37),      # ragged T and D
          (12, 4, 512, 64)]     # most rows get no entry


def _inputs(T, k, m, D, seed=0, rows=None):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(T, D)).astype(np.float32)
    if rows is None:
        idx = rng.integers(0, m, size=(T, k))
    else:                                 # every entry in a few rows
        idx = rng.choice(rows, size=(T, k))
    return g, idx.astype(np.int32)


def _check(T, k, m, D, idx, g):
    got = csr.csr_scatter_add(torch.from_numpy(g), torch.from_numpy(idx), m)
    assert got.dtype == torch.float32 and got.shape == (m, D)
    want = bloom_embed_bwd_csr_pallas(jnp.asarray(g), jnp.asarray(idx), m,
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    assert torch.equal(got, ref.csr_scatter_add_ref(
        torch.from_numpy(g), torch.from_numpy(idx), m))
    untouched = np.setdiff1d(np.arange(m), idx)
    assert not got[untouched].any()


@pytest.mark.parametrize("T,k,m,D", SHAPES)
def test_plain_matches_pallas_and_ref(T, k, m, D):
    g, idx = _inputs(T, k, m, D)
    _check(T, k, m, D, idx, g)


@pytest.mark.parametrize("rows", [[0], [3, 7, 7, 50]])
def test_collision_heavy_index_sets(rows):
    T, k, m, D = 16, 4, 64, 40
    g, idx = _inputs(T, k, m, D, seed=2, rows=rows)
    _check(T, k, m, D, idx, g)


def test_bins_are_the_stable_sort_of_the_entries():
    T, k, m = 30, 3, 16
    _, idx = _inputs(T, k, m, 1, seed=4)
    bins = csr.bin_csr(torch.from_numpy(idx), m)
    order = np.argsort(idx.reshape(-1), kind="stable")
    assert bins.src.dtype == bins.row_ptr.dtype == torch.int32
    np.testing.assert_array_equal(bins.src.numpy(), order // k)
    np.testing.assert_array_equal(bins.rows.numpy(), idx.reshape(-1)[order])
    np.testing.assert_array_equal(
        bins.row_ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(idx.reshape(-1),
                                                   minlength=m))]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_gradient_matches_jax_grad(dtype):
    d, m, k, D, B, S = 500, 128, 3, 48, 3, 7
    spec, jspec = BloomSpec(d=d, m=m, k=k), JSpec(d=d, m=m, k=k)
    rng = np.random.default_rng(5)
    table = rng.normal(size=(m, D)).astype(np.float32)
    tokens = rng.integers(0, d, size=(B, S)).astype(np.int32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)

    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_()
    out = ops.bloom_embed(tt, torch.from_numpy(tokens), spec)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert tt.grad.dtype == tt.dtype

    def f(tab):
        o = jops.bloom_embed(tab, jnp.asarray(tokens), jspec, bwd_impl="csr")
        return jnp.sum(o.astype(jnp.float32) * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(table).astype(
        getattr(jnp, dtype))).astype(jnp.float32))
    got = tt.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _ulp_bf16(want)), \
            np.abs(got - want).max()


def test_cpu_backward_launches_nothing():
    spec = BloomSpec(d=100, m=32, k=2)
    table = torch.randn(32, 8, requires_grad=True)
    common.reset_launches()
    ops.bloom_embed(table, torch.tensor([[1, 2, 3]]), spec).sum().backward()
    assert common.LAUNCHES == {}
    assert table.grad.shape == (32, 8)
    with pytest.raises(ValueError, match="one device"):
        csr.csr_scatter_add(torch.zeros(3, 8),
                            torch.zeros(3, 2, dtype=torch.int32).to("meta"),
                            32)
