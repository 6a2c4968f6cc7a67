"""The dense Bloom embedding backward of the port (``bwd_impl="dense"``:
``kernels.bloom_embed.bloom_embed_bwd`` and the gradient of
``ops.bloom_embed``) against the JAX package's ``bloom_embed_bwd_pallas``
run in interpret mode and ``jax.grad`` of its ``ops.bloom_embed`` with the
same ``bwd_impl``, on the same numpy cotangents, tables and indices; and
the ``bwd_impl`` knob of the config.

Tolerances: the f32 scatter-add within 1e-5 absolute plus 1e-6 relative
plus 2 n eps times the sum of the n magnitudes added into that row, the
bound on two orders of the same n-term f32 sum (the reference contracts
one-hot tiles on the MXU in the compiler's order; the port adds in (t, j)
order: a row that collects every entry cancels to ~0.1 from terms of ~1),
and at the reference's own bf16 tolerance
(rtol 2e-2, atol 1e-2, ``tests/test_kernels.py``) for a bf16 cotangent;
the port's dense and CSR backwards equal to each other exactly (both add
in (t, j) order from 0.0).  The embedding gradient within 1e-5 on an f32
table and within one bf16 ulp on a bf16 table.  Index sets with all
entries in a few rows, rows no entry reaches and -1 pads are included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels.bloom_embed import bloom_embed_bwd_pallas
from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_csr as csr
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common, ops, ref

from test_torch_embed import _ulp_bf16

SHAPES = [(1, 1, 16, 32, None), (7, 3, 64, 48, None),
          (16, 4, 128, 256, None), (13, 4, 96, 37, None),
          (12, 4, 512, 64, None),           # most rows get no entry
          (16, 4, 64, 40, [0]),              # every entry in one row
          (16, 4, 64, 40, [3, 7, 7, 50])]


def _inputs(T, k, m, D, rows, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(T, D)).astype(np.float32)
    idx = (rng.integers(0, m, size=(T, k)) if rows is None
           else rng.choice(rows, size=(T, k))).astype(np.int32)
    return g, idx


def _assert_within_reorder_bound(got, want, g, idx, m):
    """|got - want| <= 1e-5 + 1e-6 |want| + 2 n eps sum|g| per output, with
    n the entries summed into its row: the bound on two orders of the same
    n-term f32 sum (the port's (t, j) order, the reference's MXU order)."""
    flat = idx.reshape(-1)
    n = np.bincount(flat[(flat >= 0) & (flat < m)], minlength=m)[:, None]
    mag = be.bloom_embed_bwd_plain(g.abs(), torch.from_numpy(idx), m)
    bound = (1e-5 + 1e-6 * np.abs(np.asarray(want))
             + 2 * n * np.finfo(np.float32).eps * mag.numpy())
    err = np.abs(got.numpy() - np.asarray(want))
    assert np.all(err <= bound), float((err - bound).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,k,m,D,rows", SHAPES)
def test_dense_backward_matches_pallas(T, k, m, D, rows, dtype):
    g, idx = _inputs(T, k, m, D, rows, seed=T + D)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    common.reset_launches()
    got = be.bloom_embed_bwd(tg, torch.from_numpy(idx), m)
    assert common.LAUNCHES == {}
    assert got.dtype == torch.float32 and got.shape == (m, D)
    want = bloom_embed_bwd_pallas(jnp.asarray(g).astype(getattr(jnp, dtype)),
                                  jnp.asarray(idx), m, interpret=True)
    if dtype == "float32":
        _assert_within_reorder_bound(got, want, tg, idx, m)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                   atol=1e-2)
    assert torch.equal(got, csr.csr_scatter_add(tg, torch.from_numpy(idx),
                                                m))
    _assert_within_reorder_bound(got, ref.bloom_embed_bwd_ref(
        tg, torch.from_numpy(idx), m).numpy(), tg.float(), idx, m)
    untouched = np.setdiff1d(np.arange(m), idx)
    assert not got[untouched].any()


def test_pads_never_match():
    T, k, m, D = 10, 3, 24, 16
    g, idx = _inputs(T, k, m, D, None, seed=3)
    idx[::2, 0] = -1
    idx[1, 2] = m                      # past the table: skipped as well
    got = be.bloom_embed_bwd(torch.from_numpy(g), torch.from_numpy(idx), m)
    want = bloom_embed_bwd_pallas(jnp.asarray(g), jnp.asarray(idx), m,
                                  interpret=True)
    keep = (idx >= 0) & (idx < m)
    _assert_within_reorder_bound(got, want, torch.from_numpy(g), idx, m)
    flat = torch.from_numpy(idx[keep]).long()
    src = torch.from_numpy(np.nonzero(keep)[0])
    assert torch.equal(got, torch.zeros(m, D).index_add_(
        0, flat, torch.from_numpy(g)[src]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_gradient_matches_jax_grad(dtype):
    d, m, k, D, B, S = 500, 128, 3, 48, 3, 7
    spec, jspec = BloomSpec(d=d, m=m, k=k), JSpec(d=d, m=m, k=k)
    rng = np.random.default_rng(6)
    table = rng.normal(size=(m, D)).astype(np.float32)
    tokens = rng.integers(0, d, size=(B, S)).astype(np.int32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)

    grads = {}
    for impl in ("dense", "csr"):
        tt = torch.from_numpy(table).to(getattr(torch, dtype))
        tt.requires_grad_()
        out = ops.bloom_embed(tt, torch.from_numpy(tokens), spec,
                              bwd_impl=impl)
        (out.float() * torch.from_numpy(cot)).sum().backward()
        assert tt.grad.dtype == tt.dtype
        grads[impl] = tt.grad
    assert torch.equal(grads["dense"], grads["csr"])

    def f(tab):
        o = jops.bloom_embed(tab, jnp.asarray(tokens), jspec,
                             bwd_impl="dense")
        return jnp.sum(o.astype(jnp.float32) * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(table).astype(
        getattr(jnp, dtype))).astype(jnp.float32))
    got = grads["dense"].float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _ulp_bf16(want)), \
            np.abs(got - want).max()


def test_quantized_forward_keeps_the_dense_gradient_straight_through():
    spec = BloomSpec(d=300, m=64, k=2)
    rng = np.random.default_rng(7)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    tokens = torch.from_numpy(rng.integers(0, 300, size=(2, 5)))
    grads = []
    for td in (None, "int8"):
        tt = torch.from_numpy(table).requires_grad_()
        ops.bloom_embed(tt, tokens, spec, bwd_impl="dense",
                        table_dtype=td).sum().backward()
        grads.append(tt.grad)
    assert torch.equal(grads[0], grads[1])


def test_the_config_knob():
    assert configs.get_smoke_config("qwen1.5-0.5b").bwd_impl == "csr"
    cfg = configs.get_config("qwen1.5-0.5b", bwd_impl="dense")
    assert cfg.bwd_impl == "dense"
    with pytest.raises(ValueError, match="bwd_impl"):
        ModelConfig(bwd_impl="sparse")
    with pytest.raises(ValueError, match="bwd_impl"):
        dataclasses.replace(cfg, bwd_impl="xla")
    with pytest.raises(ValueError, match="bwd_impl"):
        be.bloom_embed(torch.zeros(4, 8), torch.zeros((2, 1),
                                                      dtype=torch.int32),
                       bwd_impl="sparse")
    with pytest.raises(ValueError):
        be.bloom_embed_bwd(torch.zeros(3, 8), torch.zeros((2, 1),
                                                          dtype=torch.int32),
                           4)
