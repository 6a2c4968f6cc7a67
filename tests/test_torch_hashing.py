"""The port's hashing (repro_torch.core.hashing) against the JAX package's:
every hash index must be bit-identical, including negative ids (hashed by
their uint32 bit pattern), 2**31-1, m == 1 and the repair rounds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th

_rng = np.random.default_rng(0)
IDS = np.concatenate([
    np.arange(-64, 2048),
    _rng.integers(-2 ** 31, 2 ** 31 - 1, size=4096),
    [2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2, 10_000_000 - 1],
]).astype(np.int32)


def _both(fn_j, fn_t, ids=IDS):
    want = np.asarray(fn_j(jnp.asarray(ids)))
    got = fn_t(torch.from_numpy(ids)).numpy()
    return want, got


def test_splitmix32_exact():
    want, got = _both(jh.splitmix32, th.splitmix32)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_double_hash_salts_exact(seed):
    assert th.double_hash_salts(seed) == jh.double_hash_salts(seed)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 2, 1000, 8192])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_double_hash_exact(k, m, seed):
    want, got = _both(lambda x: jh.double_hash(x, k, m, seed),
                      lambda x: th.double_hash(x, k, m, seed))
    assert got.dtype == np.int32 and got.shape == IDS.shape + (k,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,m,seed", [(2, 8192, 0), (4, 1000, 3),
                                      (3, 16, 1)])
def test_hash_indices_both_modes_exact(k, m, seed):
    ids = IDS[:512].reshape(8, 64)
    want, got = _both(lambda x: jh.hash_indices(x, k=k, m=m, seed=seed),
                      lambda x: th.hash_indices(x, k=k, m=m, seed=seed),
                      ids)
    np.testing.assert_array_equal(got, want)
    H = jh.make_hash_matrix(300, k, m, seed)
    want, got = _both(
        lambda x: jh.hash_indices(x, k=k, m=m, hash_matrix=H),
        lambda x: th.hash_indices(x, k=k, m=m,
                                  hash_matrix=torch.from_numpy(
                                      np.array(H))),
        ids)     # out-of-range and negative ids clamp on both sides
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,k,m,seed", [(3000, 4, 16, 0), (500, 3, 8, 5),
                                        (257, 2, 2, 7), (64, 1, 1, 0)])
def test_make_hash_matrix_with_repair_rounds_exact(d, k, m, seed):
    want = np.asarray(jh.make_hash_matrix(d, k, m, seed))
    got = th.make_hash_matrix(d, k, m, seed, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_make_hash_matrix_np_and_validation():
    np.testing.assert_array_equal(th.make_hash_matrix_np(200, 3, 50, 4),
                                  jh.make_hash_matrix_np(200, 3, 50, 4))
    with pytest.raises(ValueError, match="cannot exceed"):
        th.make_hash_matrix(10, 5, 4)
    with pytest.raises(ValueError, match="positive"):
        th.make_hash_matrix(0, 1, 4)


@pytest.mark.parametrize("k,m", [(k, m) for m in (1, 2, 3, 30208,
                                                   2 ** 31 - 1)
                                  for k in range(1, 9) if k <= m])
def test_double_hash_exact_for_every_k_up_to_8(k, m):
    """The hash the kernels re-derive (csrc/bloom_hash.cuh), at the LM's
    m, the smallest m and the largest int32 m, wherever k <= m."""
    want, got = _both(lambda x: jh.double_hash(x, k, m, 5),
                      lambda x: th.double_hash(x, k, m, 5))
    np.testing.assert_array_equal(got, want)
