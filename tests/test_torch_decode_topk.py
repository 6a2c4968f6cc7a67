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
