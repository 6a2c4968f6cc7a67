"""The port's Bloom encode/recover (repro_torch.core.bloom) against the JAX
package's on the same numpy inputs: encode exact, decode_scores within
1e-6 (f32 sums of k gathers in the same order), decode_topk ids exact, and
the lowest-id tie-break on every top-k path of both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jb
from repro.models import io as jio
from repro.kernels.bloom_decode_topk import bloom_decode_topk_pallas
from repro_torch.core import bloom as tb
from repro_torch.kernels import bloom_decode_topk as tdt
from repro_torch.models import io as tio

SPECS = [dict(d=1000, m=64, k=3, seed=1), dict(d=5000, m=256, k=2, seed=0),
         dict(d=300, m=300, k=1, seed=0)]   # the last is the identity map


def _specs(kw, on_the_fly=True):
    return (jb.BloomSpec(**kw, on_the_fly=on_the_fly),
            tb.BloomSpec(**kw, on_the_fly=on_the_fly))


def _logp(rows, m, seed=0):
    x = np.random.default_rng(seed).normal(size=(rows, m)).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("shape", [(8,), (4, 8), (2, 3, 5)])
def test_encode_exact(kw, shape):
    js, ts = _specs(kw)
    rng = np.random.default_rng(1)
    p = rng.integers(0, kw["d"], size=shape).astype(np.int32)
    p[rng.random(shape) < 0.3] = -1                       # padding
    want = np.asarray(jb.encode(js, jnp.asarray(p)))
    got = tb.encode(ts, torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("on_the_fly", [True, False])
def test_decode_scores_close(kw, on_the_fly):
    js, ts = _specs(kw, on_the_fly)
    logp = _logp(3, kw["m"])
    want = np.asarray(jb.decode_scores(js, jnp.asarray(logp), chunk=256))
    got = tb.decode_scores(ts, torch.from_numpy(logp), chunk=256).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    items = np.array([0, 5, kw["d"] - 1, 17], np.int32)
    want = np.asarray(jb.decode_scores(js, jnp.asarray(logp),
                                       item_ids=jnp.asarray(items)))
    got = tb.decode_scores(ts, torch.from_numpy(logp),
                           item_ids=torch.from_numpy(items)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("topk,chunk", [(1, 64), (12, 64), (40, 1024)])
def test_decode_topk_ids_exact(kw, topk, chunk):
    js, ts = _specs(kw)
    logp = _logp(4, kw["m"], seed=3)
    jv, ji = jb.decode_topk(js, jnp.asarray(logp), topk, chunk=chunk)
    tv, ti = tb.decode_topk(ts, torch.from_numpy(logp), topk, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_cached_hash_matrix_is_indices_for_every_id():
    _, ts = _specs(SPECS[0])
    H = tb.cached_hash_matrix(ts, "cpu")
    assert H is tb.cached_hash_matrix(ts, torch.device("cpu"))
    assert H.dtype == torch.int32 and H.shape == (ts.d, ts.k)
    np.testing.assert_array_equal(
        H.numpy(), ts.indices_for(torch.arange(ts.d)).numpy())


@pytest.mark.parametrize("logp_kind", ["constant", "collision"])
def test_topk_tiebreak_contract_all_paths(logp_kind, monkeypatch):
    """Mirror of the JAX package's three-path tie sweep: d >> the number of
    distinct (k=2, m=16) hash sets gives massive ties straddling every
    chunk=64 / v_tile=64 boundary; every path returns the lowest ids."""
    kw = dict(d=256, m=16, k=2, seed=1)
    js, ts = _specs(kw)
    topk = 12
    if logp_kind == "constant":
        logits = np.zeros((3, kw["m"]), np.float32)
    else:
        logits = np.random.default_rng(0).normal(
            size=(3, kw["m"])).astype(np.float32)
    logp = _logp_from(logits)

    ref_v, ref_i = jax.lax.top_k(jb.decode_scores(js, jnp.asarray(logp)),
                                 topk)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    if logp_kind == "constant":
        np.testing.assert_array_equal(ref_i, np.tile(np.arange(topk), (3, 1)))
    H = np.asarray(jb.cached_hash_matrix(js))
    p_v, p_i = bloom_decode_topk_pallas(jnp.asarray(logp), jnp.asarray(H),
                                        topk, b_tile=2, v_tile=64,
                                        interpret=True)
    np.testing.assert_array_equal(np.asarray(p_i), ref_i)

    lp = torch.from_numpy(logp)
    s_v, s_i = tb.decode_topk(ts, lp, topk, chunk=64)
    monkeypatch.setattr(tdt, "PLAIN_CHUNK", 64)
    k_v, k_i = tdt.bloom_decode_topk_plain(
        lp, tb.cached_hash_matrix(ts, "cpu"), topk)
    for v, i in [(s_v, s_i), (k_v, k_i)]:
        np.testing.assert_array_equal(i.numpy(), ref_i)
        np.testing.assert_allclose(v.numpy(), ref_v, rtol=1e-6)

    # the shared serving entry, with an inactive row masked
    active = torch.tensor([True, False, True])
    r_v, r_i = tio.recover_topk_spec(ts, torch.from_numpy(logits), topk,
                                     active=active)
    np.testing.assert_array_equal(r_i.numpy()[[0, 2]], ref_i[[0, 2]])
    assert np.all(r_i.numpy()[1] == 0)
    assert np.all(np.isneginf(r_v.numpy()[1]))


def _logp_from(logits):
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def test_recover_topk_identity_spec_ties_lowest_id():
    """The no-compression spec ranks the logits themselves: equal and -inf
    logits resolve to the lowest id, as the reference's Pallas decode does
    (its XLA decode returns -1 for -inf slots, ROADMAP Queue C)."""
    logits = np.array([[1, 3, 3, -np.inf, 3, 2, -np.inf]], np.float32)
    v, i = tio.recover_topk_spec(tb.identity_spec(7),
                                 torch.from_numpy(logits), 7)
    np.testing.assert_array_equal(i.numpy(), [[1, 2, 4, 5, 0, 3, 6]])
    jv, ji = jio.recover_topk_spec(jb.identity_spec(7), jnp.asarray(logits),
                                   7, impl="pallas")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
