"""The decode-topk kernel module of the port (repro_torch.kernels.
bloom_decode_topk and kernels.ops) against the JAX package's Pallas kernel
run in interpret mode, on the same numpy logp and H: ids exact and values
within 1e-6 on live rows (both sum the k gathers in j order in f32), dead
rows (-inf, 0).  On the CPU the entry takes the plain version and launches
nothing; asking for CUDA without a GPU raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bloom_decode_topk import bloom_decode_topk_pallas
from repro_torch.configs.retrieval import RetrievalConfig
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import common, ops, ref
from repro_torch.serving.retrieval import init_retrieval_params


def _inputs(B, m, d, k, seed=0):
    rng = np.random.default_rng(seed)
    logp = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(B, m)).astype(np.float32)), axis=-1))
    H = rng.integers(0, m, size=(d, k)).astype(np.int32)
    return logp, H


def _pallas(logp, H, topk, active=None):
    v, i = bloom_decode_topk_pallas(
        jnp.asarray(logp), jnp.asarray(H), topk, b_tile=4, v_tile=64,
        interpret=True,
        active=None if active is None else jnp.asarray(active))
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("B,m,d,k,topk", [
    (1, 32, 100, 1, 1), (5, 64, 333, 3, 8), (8, 128, 1024, 4, 16),
    (3, 96, 50, 2, 50),        # topk == d: a full sort
    (6, 64, 1000 + 37, 2, 10),  # ragged d: not a multiple of any tile
])
def test_plain_matches_pallas(B, m, d, k, topk):
    logp, H = _inputs(B, m, d, k)
    want_v, want_i = _pallas(logp, H, topk)
    got_v, got_i = dt.bloom_decode_topk_plain(torch.from_numpy(logp),
                                              torch.from_numpy(H), topk)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,m,d,k", [(3, 32, 100, 1), (4, 64, 333, 3)])
def test_decode_ref_matches_the_reference_and_ranks_like_plain(B, m, d, k):
    logp, H = _inputs(B, m, d, k, seed=5)
    want = np.asarray(jref.bloom_decode_ref(jnp.asarray(logp),
                                            jnp.asarray(H)))
    got = ref.bloom_decode_ref(torch.from_numpy(logp), torch.from_numpy(H))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    srt, order = torch.sort(got, dim=-1, descending=True, stable=True)
    pv, pi = dt.bloom_decode_topk_plain(torch.from_numpy(logp),
                                        torch.from_numpy(H), 7)
    assert torch.equal(pi, order[:, :7].to(torch.int32))
    assert torch.equal(pv, srt[:, :7])


@pytest.mark.parametrize("pattern", [
    [1, 0, 0, 1, 0, 0, 0, 1], [0, 0, 0, 0, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0, 0, 1]])
def test_plain_row_skipping_matches_pallas_on_live_rows(pattern):
    B, m, d, k, topk = 8, 64, 333, 3, 5
    logp, H = _inputs(B, m, d, k, seed=2)
    active = np.asarray(pattern, bool)
    want_v, want_i = _pallas(logp, H, topk, active)
    got_v, got_i = dt.bloom_decode_topk_plain(
        torch.from_numpy(logp), torch.from_numpy(H), topk,
        torch.from_numpy(active))
    np.testing.assert_array_equal(got_i.numpy()[active], want_i[active])
    np.testing.assert_allclose(got_v.numpy()[active], want_v[active],
                               rtol=1e-6, atol=1e-6)
    # the port skips per row: every dead row is (-inf, 0)
    assert np.all(got_i.numpy()[~active] == 0)
    assert np.all(np.isneginf(got_v.numpy()[~active]))


def test_all_minus_inf_rows_return_real_lowest_ids():
    """Masked vocab: most Eq. 3 scores are -inf; real ids, lowest first,
    and never a sentinel, as in the Pallas kernel."""
    B, m, d, k, topk = 3, 32, 300, 2, 8
    logp, H = _inputs(B, m, d, k)
    logp[:, 4:] = -np.inf
    want_v, want_i = _pallas(logp, H, topk)
    got_v, got_i = dt.bloom_decode_topk_plain(torch.from_numpy(logp),
                                              torch.from_numpy(H), topk)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert got_i.min() >= 0


def test_ops_on_cpu_takes_plain_version_and_launches_nothing():
    spec = BloomSpec(d=2000, m=64, k=2, seed=3)
    logp = torch.log_softmax(torch.randn(2, 3, 64), -1)
    active = torch.tensor([[True, False, True], [False, True, True]])
    common.reset_launches()
    v, i = ops.bloom_decode_topk(logp, spec, 7, active=active)
    assert common.LAUNCHES.get(dt.NAME, 0) == 0
    assert v.shape == i.shape == (2, 3, 7)
    from repro_torch.core.bloom import cached_hash_matrix
    pv, pi = dt.bloom_decode_topk_plain(logp.reshape(6, 64),
                                        cached_hash_matrix(spec, "cpu"), 7,
                                        active.reshape(6))
    assert torch.equal(i.reshape(6, 7), pi) and torch.equal(v.reshape(6, 7),
                                                            pv)


def test_impl_resolution_follows_the_tensor_device():
    x = torch.zeros(2)
    assert common.resolve_impl(x, None) == "plain"
    assert RetrievalConfig.resolved_impl("cpu") == "plain"
    assert RetrievalConfig.resolved_impl("cuda") == "kernel"
    with pytest.raises(ValueError, match="one device"):
        common.resolve_impl(x, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        dt.bloom_decode_topk_cuda(torch.zeros(2, 8), torch.zeros(
            (5, 2), dtype=torch.int32), 3)


def test_asking_for_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.resolve_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_retrieval_params(RetrievalConfig(d=100, m=16, hidden=(4,)))
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_wrapper_input_checks():
    logp = torch.zeros(2, 8)
    H = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="0 < topk <= d"):
        dt.bloom_decode_topk(logp, H, 6)
    with pytest.raises(ValueError, match="active"):
        dt.bloom_decode_topk(logp, H, 2, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\(B, m\)"):
        dt.bloom_decode_topk(logp[0], H, 2)


# --- the Hopper kernel's host-side arithmetic (runs on the CPU) -----------

def _fastmod(n, d):
    """The kernel's ``fastmod`` in numpy uint64: n % d from the wrapper's
    magic constants."""
    mp, sh = dt.magic_divisor(d)
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(mp)) >> np.uint64(32)
    q = (t + ((n - t) >> np.uint64(sh & 0xFF))) >> np.uint64(sh >> 8)
    return n - q * np.uint64(d)


@pytest.mark.parametrize("m", [1, 2, 3, 8191, 8192, 30207, 30208, 57343,
                               2 ** 31 - 1])
def test_magic_modulo_equals_remainder(m):
    mp, _ = dt.magic_divisor(m)
    assert 0 < mp < 2 ** 32
    rng = np.random.default_rng(m)
    n = np.concatenate([
        np.array([0, m - 1, m, 2 ** 32 - 1], dtype=np.uint64),
        rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64)])
    np.testing.assert_array_equal(_fastmod(n, m), n % np.uint64(m))


def _splitmix32(z):
    mask = np.uint64(0xFFFFFFFF)
    z = (z + np.uint64(0x9E3779B9)) & mask
    z = ((z ^ (z >> np.uint64(16))) * np.uint64(0x85EBCA6B)) & mask
    z = ((z ^ (z >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & mask
    return z ^ (z >> np.uint64(16))


def _kernel_hash_walk(ids, k, m, seed):
    """The kernel's in-kernel hash: h1 and h2 by the magic remainders, then
    h_j from h_{j-1} by adding h2 and j(j-1)/2 % m, one conditional
    subtraction each, in uint32."""
    from repro_torch.core import hashing
    c1, c2 = hashing.double_hash_salts(seed)
    i = np.asarray(ids, dtype=np.uint64)
    m1 = max(m - 1, 1)
    x = _fastmod(_splitmix32(i ^ np.uint64(c1)), m)
    h2 = _fastmod(_splitmix32(i ^ np.uint64(c2)), m1) + np.uint64(1)
    out = [x.copy()]
    for j in range(1, k):
        x = x + h2
        x = np.where(x >= m, x - np.uint64(m), x)
        x = x + np.uint64(j * (j - 1) // 2 % m)
        x = np.where(x >= m, x - np.uint64(m), x)
        assert x.max() < 2 ** 32
        out.append(x.copy())
    return np.stack(out, axis=-1).astype(np.int64)


@pytest.mark.parametrize("which", ["web10m", "lm", "k32"])
def test_kernel_hash_walk_equals_double_hash(which):
    from repro.core import hashing as jhashing
    from repro_torch import configs
    from repro_torch.configs.retrieval import get_retrieval_config
    from repro_torch.core import hashing
    from repro_torch.models import io as io_lib
    if which == "web10m":
        spec = get_retrieval_config("web10m").spec()
        d, k, m, seed = spec.d, spec.k, spec.m, spec.seed
    elif which == "lm":
        spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
        d, k, m, seed = spec.d, spec.k, spec.m, spec.seed
    else:   # the in-kernel hash's largest k, at the largest m
        d, k, m, seed = 10 ** 6, 32, dt.MAX_M, 7
    rng = np.random.default_rng(d + k)
    ids = np.concatenate([[0, 1, d - 1], rng.integers(0, d, 20_000)])
    want = hashing.double_hash(torch.from_numpy(ids), k, m, seed).numpy()
    np.testing.assert_array_equal(_kernel_hash_walk(ids, k, m, seed), want)
    ref = np.asarray(jhashing.double_hash(jnp.asarray(ids, jnp.int32), k, m,
                                          seed))
    np.testing.assert_array_equal(want, ref)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("topk", [1, 8, 64])
def test_plan_fits_shared_memory_for_every_m(itemsize, topk):
    """The plan's block (staged rows, warp lists, fills, the kernel's static
    arrays) fits 232,448 bytes for every m <= MAX_M, up to the kernel's 8
    rows a tile, with a row tile of at least one row and one warp."""
    for B in (1, 8, 13):
        for m in range(1, dt.MAX_M + 1):
            pl = dt.plan(B, m, itemsize, topk, 132, max_rows=dt.MAX_ROWS,
                         widen=itemsize < 4)
            assert pl.rows >= 1 and pl.warps >= 1
            assert pl.rows <= min(8, 1 << (B - 1).bit_length())
            assert pl.rows_bytes >= m * (4 if pl.widen else itemsize) \
                * pl.rows
            assert pl.rows_bytes % 16 == 0 and pl.cw >= topk + 32
            assert pl.smem + dt.SMEM_STATIC <= dt.SMEM_LIMIT
            # the last block's merge scratch: heads, then 2 * topk entries
            assert pl.rows_bytes >= 8 * pl.rows * (pl.grid + 2 * topk)


WEB10M_D, LM_D = 10_000_000, 151_936


@pytest.mark.parametrize("B,m,itemsize,topk,d,max_rows,rows,warps,wide", [
    (8, 8192, 4, 10, WEB10M_D, 4, 4, 16, 0),   # web10m f32: two tiles of 4
    (8, 8192, 2, 10, WEB10M_D, 4, 4, 16, 0),   # web10m bf16
    (8, 8192, 1, 10, WEB10M_D, 4, 4, 16, 1),   # int8 / fp8, staged as f32
    (8, 8192, 1, 10, WEB10M_D, 8, 8, 16, 0),   # all 8 rows, if asked: as
    (8, 8192, 2, 10, WEB10M_D, 8, 8, 16, 0),   # f32 they would not fit
    (8, 8192, 4, 10, WEB10M_D, 8, 4, 16, 0),   # 8 f32 rows do not fit
    (8, 30208, 4, 8, LM_D, 4, 1, 16, 0),       # LM: a block's 9.2K ids do
    (8, 30208, 2, 8, LM_D, 4, 1, 16, 0),       # not repay staging more
    (8, 30208, 1, 8, LM_D, 4, 1, 16, 0),       # rows, nor wider ones
    (8, 30208, 1, 8, None, 4, 4, 16, 0),       # ... which fit
    (8, 30208, 2, 8, None, 4, 2, 16, 0),
    (1, 30208, 1, 8, LM_D, 4, 1, 16, 0),
    (3, 64, 4, 8, None, 4, 4, 16, 0),
    (2, 56 * 1024, 4, 64, None, 4, 1, 2, 0),   # the largest row: 2 warps
])
def test_plan_rows_per_tile(B, m, itemsize, topk, d, max_rows, rows, warps,
                            wide):
    pl = dt.plan(B, m, itemsize, topk, 132, d, max_rows)
    assert (pl.rows, pl.warps, pl.grid, pl.widen) == (rows, warps, 132,
                                                       bool(wide))
    assert pl.smem + dt.SMEM_STATIC <= dt.SMEM_LIMIT
    forced = dt.plan(B, m, itemsize, topk, 132, d, max_rows, widen=True)
    assert forced.widen == (itemsize < 4 and forced.smem > 0
                            and forced.rows_bytes >= m * 4 * forced.rows)
    assert dt.plan(B, m, itemsize, topk, 132, d, max_rows=1).rows == 1
    assert dt.plan(B, m, itemsize, topk, 132, d, grid=264).grid == 264
