"""The differentiable Eq. 3 decode of the port (``kernels.bloom_decode``:
the forward over f32, bf16, fp8 and int8 logp, the dense backward, the CSR
decode caller of ``kernels.bloom_csr``, ``ops.bloom_decode``,
``core.bloom.cached_decode_bins``) and the rest of ``core.bloom``'s oracle
paths (``encode_dense``, ``recover_probabilities``) against the JAX
package, on the same numpy inputs; the Pallas kernels run in interpret
mode.

Tolerances: the forward equal to ``bloom_decode_pallas`` for f32, bf16 and
fp8 (both sum the widened values in j order; NaN at the same places for
fp8), and for int8 within 1e-6 of the Pallas kernel (its compiled
fusions move exactly tied int8 sums by an ulp) and exactly equal
to numpy's (sum q) * s.  dlogp under ``bwd_impl`` csr and dense within
1e-5 of ``jax.grad`` of the reference's ``ops.bloom_decode`` (the
reference contracts one-hot tiles on the MXU in the compiler's order;
the port adds in (i, j) order), and the port's two backwards equal to each
other exactly.  Integers (the bins' entry order) are exact.  The oracles
within 1e-6.  On the CPU every entry takes the plain version and launches
nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jbloom
from repro.core import quant as jquant
from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels.bloom_csr import CSR_E_TILE
from repro.kernels.bloom_decode import (bloom_decode_bwd_pallas,
                                        bloom_decode_pallas)
from repro.kernels.common import BWD_M_TILE
from repro_torch import configs
from repro_torch.core import bloom, quant
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_csr as csr
from repro_torch.kernels import bloom_decode as bd
from repro_torch.kernels import common, ops, ref
from repro_torch.launch import steps as steps_lib

TDS = [None, "bfloat16", "fp8_e4m3", "int8"]
SHAPES = [(1, 32, 100, 1), (5, 64, 333, 3), (8, 128, 1024, 4)]


def _inputs(B, m, d, k, seed=0):
    rng = np.random.default_rng(seed)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(
        3 * rng.normal(size=(B, m)).astype(np.float32)), axis=-1))
    logp[0, :2] = -500.0          # past fp8's range: NaN in both packages
    H = rng.integers(0, m, size=(d, k)).astype(np.int32)
    H[0, 0] = 1
    return logp, H


def _assert_equal_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("B,m,d,k", SHAPES)
@pytest.mark.parametrize("td", TDS)
def test_forward_matches_pallas(td, B, m, d, k):
    logp, H = _inputs(B, m, d, k, seed=d)
    got = bd.bloom_decode(torch.from_numpy(logp), torch.from_numpy(H),
                          table_dtype=td)
    assert got.dtype == torch.float32 and got.shape == (B, d)
    want = bloom_decode_pallas(jnp.asarray(logp), jnp.asarray(H), b_tile=4,
                               v_tile=64, interpret=True, table_dtype=td)
    if td != "int8":
        _assert_equal_nan(got.numpy(), want)
        assert np.isnan(got.numpy()).any() == (td == "fp8_e4m3")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    q, s = (np.asarray(a) for a in jquant.quantize_table(
        jnp.asarray(logp), "int8"))
    raw = q.astype(np.float32)[:, H].sum(-1, dtype=np.float32)
    np.testing.assert_array_equal(got.numpy(), raw * s[:, None])


@pytest.mark.parametrize("td", TDS)
def test_ops_decode_matches_the_reference_ops(td):
    d, m, k = 600, 128, 3
    spec, jspec = BloomSpec(d=d, m=m, k=k), JSpec(d=d, m=m, k=k)
    logp, _ = _inputs(6, m, d, k, seed=1)
    logp = logp.reshape(2, 3, m)
    common.reset_launches()
    got = ops.bloom_decode(torch.from_numpy(logp), spec, table_dtype=td)
    assert common.LAUNCHES == {} and got.shape == (2, 3, d)
    want = jops.bloom_decode(jnp.asarray(logp), jspec, table_dtype=td)
    if td == "int8":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    else:
        _assert_equal_nan(got.numpy(), want)


@pytest.mark.parametrize("td", [None, "int8"])
@pytest.mark.parametrize("bwd_impl", ["csr", "dense"])
def test_gradient_matches_jax_grad(bwd_impl, td):
    d, m, k = 700, 96, 3
    spec, jspec = BloomSpec(d=d, m=m, k=k), JSpec(d=d, m=m, k=k)
    rng = np.random.default_rng(2)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(
        rng.normal(size=(2, 4, m)).astype(np.float32)), axis=-1))
    cot = rng.normal(size=(2, 4, d)).astype(np.float32)

    def grad(impl, tdt):
        x = torch.from_numpy(logp).requires_grad_()
        s = ops.bloom_decode(x, spec, bwd_impl=impl, table_dtype=tdt)
        g, = torch.autograd.grad(s, x, torch.from_numpy(cot))
        return g

    got = grad(bwd_impl, td)
    assert got.dtype == torch.float32 and got.shape == logp.shape
    want = jax.grad(lambda x: jnp.sum(jops.bloom_decode(
        x, jspec, bwd_impl=bwd_impl, table_dtype=td) * cot))(
            jnp.asarray(logp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # both backwards add in (i, j) order; quantized grads straight-through
    assert torch.equal(got, grad("dense" if bwd_impl == "csr" else "csr",
                                 None))


def test_gradient_comes_back_in_the_dtype_of_logp():
    spec = BloomSpec(d=300, m=64, k=2)
    x = torch.randn(3, 64, dtype=torch.float64).log_softmax(-1)
    x.requires_grad_()
    ops.bloom_decode(x, spec, bwd_impl="dense").sum().backward()
    assert x.grad.dtype == torch.float64
    want = bd.bloom_decode_bwd_plain(torch.ones(3, 300),
                                     bloom.cached_hash_matrix(spec, "cpu"), 64)
    assert torch.equal(x.grad.float(), want)


def test_caller_hash_matrix_bins_in_the_backward():
    spec = BloomSpec(d=400, m=80, k=3)
    H = bloom.cached_hash_matrix(spec, "cpu")
    rng = np.random.default_rng(3)
    logp = torch.from_numpy(rng.normal(size=(2, 80)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2, 400)).astype(np.float32))
    out = []
    for hm in (None, H.clone()):
        x = logp.clone().requires_grad_()
        s = ops.bloom_decode(x, spec, hash_matrix=hm)
        out.append((s.detach(), torch.autograd.grad(s, x, cot)[0]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("B,d,m,k", [(1, 100, 32, 1), (3, 1000, 77, 3),
                                     (4, 2048, 512, 4)])
def test_dense_backward_matches_pallas(B, d, m, k):
    rng = np.random.default_rng(B + d)
    g = rng.normal(size=(B, d)).astype(np.float32)
    H = rng.integers(0, m, size=(d, k)).astype(np.int32)
    H[::7, -1] = -1                      # pads never match
    got = bd.bloom_decode_bwd(torch.from_numpy(g), torch.from_numpy(H), m)
    assert got.dtype == torch.float32 and got.shape == (B, m)
    want = bloom_decode_bwd_pallas(jnp.asarray(g), jnp.asarray(H), m,
                                   v_tile=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.bloom_decode_bwd_ref(
        torch.from_numpy(g), torch.from_numpy(H), m).numpy(), rtol=0,
        atol=1e-5)
    assert torch.equal(got, csr.bloom_decode_bwd_csr(
        torch.from_numpy(g), torch.from_numpy(H), m))


def test_cached_decode_bins_match_the_reference_entry_order():
    spec, jspec = BloomSpec(d=900, m=96, k=3), JSpec(d=900, m=96, k=3)
    bins = bloom.cached_decode_bins(spec, "cpu")
    assert bins is bloom.cached_decode_bins(spec, torch.device("cpu"))
    jb = jbloom.cached_decode_bins(jspec, BWD_M_TILE, CSR_E_TILE)
    val = np.asarray(jb.val).reshape(-1)
    live = val >= 0
    order = np.argsort(val[live], kind="stable")
    np.testing.assert_array_equal(
        np.repeat(np.arange(spec.m), np.diff(bins.row_ptr.numpy())),
        val[live][order])
    np.testing.assert_array_equal(bins.src.numpy(),
                                  np.asarray(jb.tok)[live][order])
    assert int(bins.row_ptr[-1]) == spec.d * spec.k


def test_warm_bloom_caches_builds_the_decode_bins_for_csr_only():
    bloom._cached_decode_bins.cache_clear()
    cfg = configs.get_smoke_config("qwen1.5-0.5b")
    model = steps_lib.init_fn_for(cfg)(0)
    steps_lib.warm_bloom_caches(cfg, model)
    assert bloom._cached_decode_bins.cache_info().currsize == 0
    steps_lib.warm_bloom_caches(configs.get_smoke_config(
        "qwen1.5-0.5b", bwd_impl="dense"), model, decode_grad=True)
    assert bloom._cached_decode_bins.cache_info().currsize == 0
    steps_lib.warm_bloom_caches(cfg, model, decode_grad=True)
    assert bloom._cached_decode_bins.cache_info().currsize == 1


def test_wrapper_checks_and_names():
    logp, H = torch.randn(2, 16), torch.randint(0, 16, (10, 2),
                                                dtype=torch.int32)
    with pytest.raises(ValueError, match="bwd_impl"):
        bd.bloom_decode(logp, H, bwd_impl="sparse")
    with pytest.raises(ValueError, match="bwd_impl"):
        ops.bloom_decode(logp, BloomSpec(d=20, m=16, k=2), bwd_impl="x")
    with pytest.raises(ValueError, match="scales"):
        bd.bloom_decode_fwd(logp.to(torch.int8), H)
    with pytest.raises(TypeError):
        bd.bloom_decode_fwd(logp.to(torch.int16), H)
    with pytest.raises(ValueError, match="one device"):
        bd.bloom_decode_fwd(logp, H.to("meta"))
    with pytest.raises(ValueError):
        bd.bloom_decode_bwd(torch.zeros(2, 9), H, 16)
    assert bd.variant_name(torch.float32) == "bloom_decode"
    assert bd.variant_name(torch.int8) == "bloom_decode.int8"
    assert csr.DECODE == "bloom_csr.decode"
    assert bd.min_bytes(8, 30208, 151936, 4) == 8_259_584


@pytest.mark.parametrize("on_the_fly", [True, False])
def test_encode_dense_matches_the_reference(on_the_fly):
    d, m, k = 200, 48, 3
    spec = BloomSpec(d=d, m=m, k=k, on_the_fly=on_the_fly)
    jspec = JSpec(d=d, m=m, k=k, on_the_fly=on_the_fly)
    x = (np.random.default_rng(4).random((3, 5, d)) < 0.05).astype(
        np.float32)
    got = bloom.encode_dense(spec, torch.from_numpy(x))
    want = jbloom.encode_dense(jspec, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    items = [np.nonzero(r)[0] for r in x.reshape(-1, d)]
    p = np.full((len(items), d), -1, np.int64)
    for i, it in enumerate(items):
        p[i, :len(it)] = it
    assert torch.equal(got.reshape(-1, m),
                       bloom.encode(spec, torch.from_numpy(p)))


def test_recover_probabilities_matches_the_reference():
    d, m, k = 300, 64, 2
    spec, jspec = BloomSpec(d=d, m=m, k=k), JSpec(d=d, m=m, k=k)
    rng = np.random.default_rng(5)
    v = rng.random((4, m)).astype(np.float32)
    v[0, :3] = 0.0                     # clipped to eps before the log
    got = bloom.recover_probabilities(spec, torch.from_numpy(v))
    want = jbloom.recover_probabilities(jspec, jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
