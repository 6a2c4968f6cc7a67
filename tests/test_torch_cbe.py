"""CBE (Algorithm 1, ``repro_torch.core.cbe``) and counting Bloom
embeddings (``repro_torch.core.counting``) against the JAX package's.

Exact: ``cooccurrence_stats`` (the same floats) and ``cbe_hash_matrix``
(the same integers, every ``max_pairs``, on random and on the paper
tasks' own instance matrices).  Counting: the encoding (whole numbers in
f32) equal; the loss and its gradient, and the Eq. 3 decode, within
1e-6 (f32 reductions in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import counting as j_cnt
from repro.core import hashing as j_hash
from repro.core.bloom import BloomSpec as JSpec
from repro.core.cbe import cbe_hash_matrix as j_cbe
from repro.core.cbe import cooccurrence_stats as j_stats
from repro.data import synthetic as j_syn
from repro_torch.core import counting as t_cnt
from repro_torch.core import hashing as t_hash
from repro_torch.core.bloom import BloomSpec as TSpec
from repro_torch.core.cbe import cbe_hash_matrix as t_cbe
from repro_torch.core.cbe import cooccurrence_stats as t_stats

TOL = dict(rtol=1e-6, atol=1e-6)


def _X(n=400, d=60, density=0.06, seed=0):
    X = sp.random(n, d, density=density, format="csr",
                  random_state=np.random.default_rng(seed))
    X.data[:] = 1.0
    return X


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_cooccurrence_stats_equal_the_reference(seed):
    X = _X(seed=seed)
    assert t_stats(X) == j_stats(X)


@pytest.mark.parametrize("seed,k,m,max_pairs", [
    (0, 4, 20, None), (3, 4, 20, 5), (5, 3, 12, 100), (1, 1, 30, None),
    (2, 8, 16, 50)])
def test_cbe_hash_matrix_equals_the_reference(seed, k, m, max_pairs):
    X = _X(seed=seed)
    H = t_hash.make_hash_matrix_np(60, k, m, seed=seed)
    np.testing.assert_array_equal(H, j_hash.make_hash_matrix_np(
        60, k, m, seed=seed))
    got = t_cbe(X, H, m, seed=seed, max_pairs=max_pairs)
    want = j_cbe(X, H, m, seed=seed, max_pairs=max_pairs)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_cbe_on_a_paper_task_matrix_equals_the_reference():
    """Table 5's own input: a recsys task's X_in and X_out, at MSD's
    d = 2,400 and m/d = 0.1, k = 4, max_pairs = 2,000."""
    data = j_syn.make_recsys(n=300, d=2400, mean_items=5, seed=11)
    for X, seed in ((data.X_in, 0), (data.X_out, 1)):
        assert t_stats(X) == j_stats(X)
        H = t_hash.make_hash_matrix_np(2400, 4, 240, seed=seed)
        np.testing.assert_array_equal(
            t_cbe(X, H, 240, seed=seed, max_pairs=2000),
            j_cbe(X, H, 240, seed=seed, max_pairs=2000))


P = np.array([[1, 2, 3, -1], [4, 9, 100, 599], [-1, -1, -1, -1],
              [7, 7, 5, -1]], np.int32)


@pytest.mark.parametrize("d,m,k,seed", [(600, 48, 3, 1), (600, 20, 4, 0),
                                         (600, 600, 1, 0), (600, 8, 8, 2)])
def test_encode_counting_equals_the_reference(d, m, k, seed):
    got = t_cnt.encode_counting(TSpec(d=d, m=m, k=k, seed=seed),
                                torch.from_numpy(P))
    want = np.asarray(j_cnt.encode_counting(JSpec(d=d, m=m, k=k, seed=seed),
                                            jnp.asarray(P)))
    assert got.dtype == torch.float32 and got.shape == (4, m)
    np.testing.assert_array_equal(got.numpy(), want)
    # -1 pads add nothing: each row's mass is k x its valid ids
    np.testing.assert_array_equal(got.sum(-1).numpy(),
                                  k * (P >= 0).sum(-1))


def test_encode_counting_with_a_hash_matrix_and_a_time_axis():
    """An explicit (d, k) H (CBE's) and (B, T, 1) id sets (the session
    tasks' encode_seq)."""
    H = j_hash.make_hash_matrix_np(600, 3, 48, seed=4)
    p3 = P[..., None]
    got = t_cnt.encode_counting(TSpec(d=600, m=48, k=3), torch.from_numpy(p3),
                                torch.from_numpy(H))
    want = np.asarray(j_cnt.encode_counting(
        JSpec(d=600, m=48, k=3), jnp.asarray(p3), jnp.asarray(H)))
    assert got.shape == (4, 4, 48)
    np.testing.assert_array_equal(got.numpy(), want)


def test_counting_loss_and_gradient_equal_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 48)).astype(np.float32)
    tspec, jspec = TSpec(d=600, m=48, k=3, seed=1), JSpec(d=600, m=48, k=3,
                                                          seed=1)
    z = torch.from_numpy(logits).requires_grad_(True)
    got = t_cnt.counting_xent_multilabel(tspec, z, torch.from_numpy(P))
    got.sum().backward()
    want = np.asarray(j_cnt.counting_xent_multilabel(
        jspec, jnp.asarray(logits), jnp.asarray(P)))
    g_want = np.asarray(jax.grad(lambda x: j_cnt.counting_xent_multilabel(
        jspec, x, jnp.asarray(P)).sum())(jnp.asarray(logits)))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert float(got[2].detach()) == 0.0   # an all-pad row: target 0, loss 0
    np.testing.assert_allclose(z.grad.numpy(), g_want, **TOL)


def test_counting_io_equals_the_reference():
    t = t_cnt.CountingBloomIO(d=80, m=24, k=3, seed=2, device="cpu")
    j = j_cnt.CountingBloomIO(d=80, m=24, k=3, seed=2)
    assert (t.name, t.d, t.m_in, t.m_out) == (j.name, j.d, j.m_in, j.m_out)
    for ts, js in ((t.spec_in, j.spec_in), (t.spec_out, j.spec_out)):
        assert (ts.d, ts.m, ts.k, ts.seed) == (js.d, js.m, js.k, js.seed)
    p = np.array([[1, 2, 5, -1], [7, -1, -1, -1]], np.int32)
    pred = np.random.default_rng(1).normal(size=(2, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        t.encode_input(torch.from_numpy(p)).numpy(),
        np.asarray(j.encode_input(jnp.asarray(p))))
    np.testing.assert_allclose(
        t.loss(torch.from_numpy(pred), torch.from_numpy(p)).numpy(),
        np.asarray(j.loss(jnp.asarray(pred), jnp.asarray(p))), **TOL)
    scores = t.decode(torch.from_numpy(pred))
    assert scores.shape == (2, 80)
    np.testing.assert_allclose(scores.numpy(),
                               np.asarray(j.decode(jnp.asarray(pred))),
                               **TOL)


def test_counting_io_checks_its_device():
    with pytest.raises(ValueError):
        t_cnt.CountingBloomIO(d=80, m=24, device="meta")
