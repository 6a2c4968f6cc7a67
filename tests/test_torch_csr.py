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
from repro_torch.kernels import bloom_decode as bd
from repro_torch.kernels import bloom_embed as be
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
    row_ptr = bins.row_ptr.numpy()
    np.testing.assert_array_equal(
        np.repeat(np.arange(m), np.diff(row_ptr)), idx.reshape(-1)[order])
    np.testing.assert_array_equal(
        row_ptr,
        np.concatenate([[0], np.cumsum(np.bincount(idx.reshape(-1),
                                                   minlength=m))]))


def test_out_of_range_entries_bin_outside_every_row_in_entry_order():
    """Values below 0 sort as -1 and values from m up as m: the row
    pointers count only [0, m), and the entries before row_ptr[0] and from
    row_ptr[m] on keep their entry order (the rule the card's binning
    reproduces)."""
    m, k = 6, 2
    idx = torch.tensor([[7, -1], [2, -5], [6, 2], [-2, 9], [0, 2]],
                       dtype=torch.int32)
    bins = csr.bin_csr(idx, m)
    assert bins.row_ptr.tolist() == [3, 4, 4, 7, 7, 7, 7]
    # -1 (t0), -5 (t1), -2 (t3); row 0 (t4); row 2 (t1, t2, t4); 7, 6, 9
    assert bins.src.tolist() == [0, 1, 3, 4, 1, 2, 4, 0, 2, 3]
    g = torch.randn(5, 3)
    assert torch.equal(csr.csr_scatter_add(g, idx, m),
                       be.bloom_embed_bwd_plain(g, idx, m))


@pytest.mark.parametrize("m,D,vec,rows", [
    (30208, 1024, True, 8),      # the train step: 8 chunks a thread
    (30208, 8, True, 128),       # the decode caller: a pair a thread
    (30208, 37, False, 55), (64, 1024, True, 1),
    (10, 4, True, 256),          # a pair a thread, past m
    (10 ** 6, 4, True, 1024),    # halved to 4 blocks an SM
    (10 ** 7, 4, True, 2048)])   # capped at MAX_ROWS
def test_rows_per_block(m, D, vec, rows):
    got = csr.rows_per_block(m, D, vec, n_sm=132)
    assert got == rows and 1 <= got <= csr.MAX_ROWS
    cpr = D // 4 if vec else D
    assert got * cpr <= max(csr.PAIRS_PER_BLOCK, cpr)


@pytest.mark.parametrize("n,m,chunk,scratch", [
    (2080, 30208, 0, 0),                       # the train step: one launch
    (8192, 70000, 0, 0),
    (607744, 30208, 2048, 607744 + 473 * 298),        # the decode's H
    (8193, 10, 2048, 8193 + 1 * 6),
    (3 * 2 ** 21, 2 ** 17 - 2, 6144, 3 * 2 ** 21 + 2048 * 1025)])
def test_bin_plan(n, m, chunk, scratch):
    assert csr.bin_plan(n, m) == (chunk, scratch)
    if chunk:
        assert chunk % csr.SUB == 0 and -(-n // chunk) <= csr.MAX_CHUNKS


def test_cuda_wrappers_raise_before_a_launch_on_cpu_tensors():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    common.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        csr.bin_csr_cuda(idx, 16)
    with pytest.raises(ValueError, match="CUDA"):
        csr.csr_scatter_add_cuda(torch.zeros(4, 8), csr.bin_csr(idx, 16), 16)
    with pytest.raises(ValueError, match="CUDA"):
        bd.bloom_decode_bwd_cuda(torch.zeros(2, 4), idx, 16)
    assert common.LAUNCHES == {}


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
