"""The port's IO embeddings (``repro_torch.core.alternatives``) and the
recommender losses against the JAX package's, on the inputs of
``tests/test_alternatives.py``.

Integers and host-side fits are exact: the ECOC code matrix, the hash
indices, the PMI and CCA vectors (the same NumPy/SciPy code on the same
seeds).  Encode, loss and decode agree within 1e-5 (f32 reductions in
another order); the three losses on their own within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import alternatives as jalt
from repro.core import hashing as jhashing
from repro.core import losses as jlosses
from repro.core.bloom import BloomSpec as JSpec
from repro.core.cbe import cbe_hash_matrix
from repro_torch.core import alternatives as talt
from repro_torch.core import losses as tlosses
from repro_torch.core.bloom import BloomSpec as TSpec

D = 50
P_IN = np.array([[1, 5, 9, -1], [0, -1, -1, -1]], np.int32)
Q_OUT = np.array([[2, 3, -1, -1], [7, 8, -1, -1]], np.int32)


def _X(n=300, d=D, seed=0):
    X = sp.random(n, d, density=0.08, format="csr",
                  random_state=np.random.default_rng(seed))
    X.data[:] = 1.0
    return X


def _agree(jemb, temb):
    """encode, loss and decode of both embeddings on the same inputs."""
    assert (temb.name, temb.d, temb.m_in, temb.m_out) == \
        (jemb.name, jemb.d, jemb.m_in, jemb.m_out)
    x_j = np.asarray(jemb.encode_input(jnp.asarray(P_IN)))
    x_t = temb.encode_input(torch.from_numpy(P_IN)).numpy()
    assert x_t.shape == (2, temb.m_in)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-5, atol=1e-5)
    pred = np.random.default_rng(0).normal(
        size=(2, temb.m_out)).astype(np.float32)
    l_j = np.asarray(jemb.loss(jnp.asarray(pred), jnp.asarray(Q_OUT)))
    l_t = temb.loss(torch.from_numpy(pred), torch.from_numpy(Q_OUT))
    assert l_t.shape == (2,) and torch.isfinite(l_t).all()
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=1e-5, atol=1e-5)
    s_j = np.asarray(jemb.decode(jnp.asarray(pred)))
    s_t = temb.decode(torch.from_numpy(pred)).numpy()
    assert s_t.shape == (2, D) and np.isfinite(s_t).all()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-5)


def _same_spec(t, j):
    assert (t.d, t.m, t.k, t.seed, t.on_the_fly) == \
        (j.d, j.m, j.k, j.seed, j.on_the_fly)


def test_bloom_io_matches_and_hashes_equal():
    jemb = jalt.BloomIO.build(d=D, m=20, k=3)
    temb = talt.BloomIO.build(d=D, m=20, k=3, device="cpu")
    _same_spec(temb.spec_in, jemb.spec_in)
    _same_spec(temb.spec_out, jemb.spec_out)
    assert temb.spec_out.seed == temb.spec_in.seed + 1
    ids = np.arange(D, dtype=np.int32)
    for ts, js in ((temb.spec_in, jemb.spec_in),
                   (temb.spec_out, jemb.spec_out)):
        assert np.array_equal(ts.indices_for(torch.from_numpy(ids)).numpy(),
                              np.asarray(js.indices_for(jnp.asarray(ids))))
    _agree(jemb, temb)


def test_hashing_trick_is_k1_bloom():
    jemb, temb = jalt.hashing_trick(D, 20), talt.hashing_trick(
        D, 20, device="cpu")
    assert temb.spec_in.k == 1 and temb.name == "HT"
    _agree(jemb, temb)


def test_bloom_io_with_cbe_matrices():
    X = _X()
    H_in = jhashing.make_hash_matrix_np(D, 3, 20, seed=0)
    H_cbe = np.asarray(cbe_hash_matrix(X, H_in, 20, seed=0))
    jemb = jalt.BloomIO.build(d=D, m=20, k=3, H_in=H_cbe, H_out=H_cbe,
                              name="CBE")
    temb = talt.BloomIO.build(d=D, m=20, k=3, H_in=H_cbe, H_out=H_cbe,
                              name="CBE", device="cpu")
    assert not temb.spec_in.on_the_fly and not temb.spec_out.on_the_fly
    assert np.array_equal(temb.H_in.numpy(), H_cbe)
    _agree(jemb, temb)


def test_ecoc_code_matrix_and_interface():
    jemb = jalt.ECOCIO.build(D, 24, iters=50)
    temb = talt.ECOCIO.build(D, 24, iters=50, device="cpu")
    assert np.array_equal(talt._ecoc_code_matrix(D, 24, 3, 20),
                          jalt._ecoc_code_matrix(D, 24, 3, 20))
    assert np.array_equal(temb.code.numpy(), np.asarray(jemb.code))
    _agree(jemb, temb)


def test_pmi_vectors_and_interface():
    X = _X()
    assert np.array_equal(talt._pmi_vectors(X, 16), jalt._pmi_vectors(X, 16))
    jemb = jalt.PMIIO.build(X, m=16)
    temb = talt.PMIIO.build(X, m=16, device="cpu")
    assert np.array_equal(temb.vecs.numpy(), np.asarray(jemb.vecs))
    _agree(jemb, temb)


def test_cca_projections_and_interface():
    X = _X()
    Y = _X(seed=1)
    jemb = jalt.CCAIO.build(X, Y, m=16)
    temb = talt.CCAIO.build(X, Y, m=16, device="cpu")
    assert np.array_equal(temb.U.numpy(), np.asarray(jemb.U))
    assert np.array_equal(temb.V.numpy(), np.asarray(jemb.V))
    _agree(jemb, temb)


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default is the card here; this checks the raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talt.ECOCIO.build(D, 8, iters=1)


def test_softmax_xent_dense_matches():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 3, 11)).astype(np.float32) * 3
    target = rng.random((4, 3, 11)).astype(np.float32)
    target[0, 1] = 0.0                     # a masked row
    want = np.asarray(jlosses.softmax_xent_dense(jnp.asarray(logits),
                                                 jnp.asarray(target)))
    got = tlosses.softmax_xent_dense(torch.from_numpy(logits),
                                     torch.from_numpy(target)).numpy()
    assert got[0, 1] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,on_the_fly", [(2, True), (3, False)])
def test_bloom_xent_multilabel_matches(k, on_the_fly):
    d, m = 300, 40
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(6, m)).astype(np.float32) * 2
    targets = rng.integers(0, d, size=(6, 4)).astype(np.int32)
    targets[1, 2:] = -1                    # -1 pads encode to nothing
    targets[2, 1] = targets[2, 0]          # a repeated item
    targets[3] = -1                        # a row whose target sums to 0
    js = JSpec(d=d, m=m, k=k, seed=5, on_the_fly=on_the_fly)
    ts = TSpec(d=d, m=m, k=k, seed=5, on_the_fly=on_the_fly)
    want = np.asarray(jlosses.bloom_xent_multilabel(
        js, jnp.asarray(logits), jnp.asarray(targets)))
    got = tlosses.bloom_xent_multilabel(ts, torch.from_numpy(logits),
                                        torch.from_numpy(targets)).numpy()
    assert got[3] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cosine_proximity_loss_matches():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(5, 9)).astype(np.float32)
    target = rng.normal(size=(5, 9)).astype(np.float32)
    target[4] = 0.0                        # eps keeps a zero row finite
    want = np.asarray(jlosses.cosine_proximity_loss(jnp.asarray(pred),
                                                    jnp.asarray(target)))
    got = tlosses.cosine_proximity_loss(torch.from_numpy(pred),
                                        torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
