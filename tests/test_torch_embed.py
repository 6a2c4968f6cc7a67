"""The Bloom embedding forward of the port (repro_torch.kernels.
bloom_embed, kernels.ref.bloom_embed_ref and kernels.ops.bloom_embed)
against the JAX package's Pallas ``bloom_embed_pallas`` run in interpret
mode and its ``ref.bloom_embed_ref``, on the same numpy table and indices.

Tolerances: f32 within atol 1e-6 (rtol 0), because the reference may sum
the k rows in another order; bf16 within one bf16 ulp of the reference,
because a different f32 sum order can round to the neighbouring bf16
value.  On the CPU the entry takes the plain version and launches
nothing; asking for CUDA without a GPU raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bloom_embed import bloom_embed_pallas
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common, ops, ref

SHAPES = [(1, 1, 16, 32), (7, 3, 64, 48), (32, 4, 128, 256),
          (19, 4, 96, 37),      # ragged T and D: multiples of no tile
          (1, 4, 512, 1024)]    # the LM decode row width, T = 1


def _inputs(T, k, m, D, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(m, D)).astype(np.float32)
    idx = rng.integers(0, m, size=(T, k)).astype(np.int32)
    return table, idx


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.where(x == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))


def _assert_close(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _ulp_bf16(want)), \
            np.abs(got - want).max()


@pytest.mark.parametrize("T,k,m,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(T, k, m, D, dtype):
    table, idx = _inputs(T, k, m, D)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = be.bloom_embed_plain(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and got.shape == (T, D)
    pallas = bloom_embed_pallas(jt, jnp.asarray(idx), d_tile=256,
                                interpret=True)
    _assert_close(got, pallas, dtype)
    _assert_close(got, jref.bloom_embed_ref(jt, jnp.asarray(idx)), dtype)
    _assert_close(ref.bloom_embed_ref(tt, torch.from_numpy(idx)),
                  jref.bloom_embed_ref(jt, jnp.asarray(idx)), dtype)


def test_plain_sums_in_f32_in_j_order_and_rounds_once():
    """bf16 rows whose bf16 running sum would lose the small terms."""
    table = torch.tensor([[256.0], [1.0], [1.0], [-256.0]],
                         dtype=torch.bfloat16)
    idx = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    assert be.bloom_embed_plain(table, idx).item() == 2.0


def test_ops_matches_the_reference_ops_and_launches_nothing_on_cpu():
    spec, jspec = BloomSpec(d=500, m=128, k=4, seed=3), \
        JSpec(d=500, m=128, k=4, seed=3)
    rng = np.random.default_rng(1)
    table = rng.normal(size=(128, 64)).astype(np.float32)
    tokens = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    common.reset_launches()
    got = ops.bloom_embed(torch.from_numpy(table), torch.from_numpy(tokens),
                          spec)
    assert common.LAUNCHES.get(be.NAME, 0) == 0
    want = jops.bloom_embed(jnp.asarray(table), jnp.asarray(tokens), jspec)
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_cpu_plain_version_is_differentiable():
    table = torch.randn(16, 8, requires_grad=True)
    idx = torch.tensor([[1, 2], [2, 2]], dtype=torch.int32)
    be.bloom_embed(table, idx).sum().backward()
    want = torch.zeros(16, 8)
    want[1] += 1
    want[2] += 3
    assert torch.equal(table.grad, want)


def test_asking_for_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_device("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        be.bloom_embed_cuda(torch.zeros(4, 8),
                            torch.zeros((2, 1), dtype=torch.int32))


def test_wrapper_input_checks():
    with pytest.raises(ValueError, match=r"\(m, D\)"):
        be.bloom_embed(torch.zeros(8), torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="k >= 1"):
        be.bloom_embed(torch.zeros(4, 8), torch.zeros((2, 0),
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="one device"):
        be.bloom_embed(torch.zeros(4, 8),
                       torch.zeros((2, 1), dtype=torch.int32, device="meta"))


def test_min_bytes_counts_distinct_rows_indices_and_output():
    assert be.min_bytes(3, 8, 4, 1024, 2) == 3 * 1024 * 2 + 8 * 4 * 4 \
        + 8 * 1024 * 2
