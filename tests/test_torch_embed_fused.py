"""The Bloom embedding's token entry (``kernels.bloom_embed``: the embed
kernel hashing token ids itself, and its plain version
``bloom_embed_tokens_plain``, which ``ops.bloom_embed`` takes on the CPU)
against the JAX package, and the host arithmetic of the two kernels that
hash or plan on the card: the embed kernel's in-kernel double hash
(``csrc/bloom_hash.cuh``, emulated in numpy) and the Eq. 3 decode forward's
launch ``plan`` (``kernels.bloom_decode``).

Tolerances: integers (hash indices, the indices the token entry hands its
backward) exact; the f32 embedding within rtol 1e-6 / atol 1e-6 of the
reference's ``models/io.embed_tokens`` with ``io_impl="pallas"`` (the
Pallas kernel in interpret mode, or its forward-only quantized entry):
both sum the k widened rows in f32, torch in j order and XLA in its own
order of the same k terms, so they may differ in the last ulp; the
gradient through the token entry (csr and dense) within 1e-4 of
``jax.grad`` of the reference's ``ops.bloom_embed``, the reference's own
gradient tolerance.  On the CPU nothing is launched."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hashing as jhashing
from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.models import io as j_io
from repro_torch import configs as tconfigs
from repro_torch.core import bloom, hashing
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_decode as bd
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common, ops
from repro_torch.models import io as t_io

ARCH = "qwen1.5-0.5b"
D_MODEL = 64
# (d, m_ratio, k, on_the_fly): the double hash at k = 1, 3, 4, the
# precomputed hash matrix, the identity spec (m == d, k == 1)
SPECS = {"hash k=1": (300, 0.25, 1, True), "hash k=3": (300, 0.25, 3, True),
         "hash k=4": (500, 0.2, 4, True), "H k=3": (300, 0.25, 3, False),
         "H k=4": (500, 0.2, 4, False), "identity": (200, 1.0, 1, True)}
TDS = ["auto", "float32", "bfloat16", "int8", "fp8_e4m3"]


def _cfgs(name, td):
    d, ratio, k, fly = SPECS[name]
    over = dict(vocab=d, d_model=D_MODEL, dtype="float32", table_dtype=td)
    jcfg = jconfigs.get_smoke_config(
        ARCH, bloom=jconfigs.BloomConfig(True, ratio, k, 5, fly),
        io_impl="pallas", **over)
    tcfg = tconfigs.get_smoke_config(
        ARCH, bloom=tconfigs.BloomConfig(True, ratio, k, 5, fly), **over)
    assert jcfg.m_vocab == tcfg.m_vocab
    return jcfg, tcfg


def _tokens(d, seed=0):
    """Token ids with 0, d - 1 and the -1 pad among random ones."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, d, size=(3, 7)).astype(np.int32)
    tok[0, :3] = [0, d - 1, -1]
    tok[2, -1] = -1
    return tok


@pytest.mark.parametrize("td", TDS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_token_entry_matches_the_reference_embed_tokens(name, td):
    jcfg, tcfg = _cfgs(name, td)
    rng = np.random.default_rng(1)
    table = rng.normal(size=(tcfg.m_vocab, D_MODEL)).astype(np.float32)
    tok = _tokens(tcfg.vocab)
    common.reset_launches()
    with torch.no_grad():
        got = t_io.embed_tokens(torch.from_numpy(table), tcfg,
                                torch.from_numpy(tok).long())
    assert common.LAUNCHES == {}
    want = j_io.embed_tokens({"embed": jnp.asarray(table)}, jcfg,
                             jnp.asarray(tok))
    assert got.dtype == torch.float32 and got.shape == (3, 7, D_MODEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_token_entry_indices_equal_indices_for_and_the_reference(name):
    _, tcfg = _cfgs(name, "auto")
    spec = t_io.vocab_spec(tcfg)
    jspec = JSpec(d=spec.d, m=spec.m, k=spec.k, seed=spec.seed,
                  on_the_fly=spec.on_the_fly)
    tok = _tokens(spec.d, seed=2).reshape(-1)
    for dtype in (torch.int32, torch.int64):
        tokens = torch.from_numpy(tok).to(dtype)
        table = torch.randn(spec.m, 8)
        out, idx = be.bloom_embed_tokens_plain(table, None, tokens, spec,
                                               torch.float32)
        assert idx.dtype == torch.int32 and idx.shape == (tok.size, spec.k)
        assert torch.equal(idx, spec.indices_for(tokens))
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jspec.indices_for(jnp.asarray(tok))))
        assert torch.equal(out, be.bloom_embed_plain(table, idx))


@pytest.mark.parametrize("td", [None, "int8"])
@pytest.mark.parametrize("bwd_impl", ["csr", "dense"])
@pytest.mark.parametrize("name", ["hash k=4", "H k=3", "identity"])
def test_gradient_through_the_token_entry_matches_jax_grad(name, bwd_impl,
                                                           td):
    d, ratio, k, fly = SPECS[name]
    _, tcfg = _cfgs(name, "auto")
    m = tcfg.m_vocab
    spec = BloomSpec(d=d, m=m, k=k, seed=5, on_the_fly=fly)
    jspec = JSpec(d=d, m=m, k=k, seed=5, on_the_fly=fly)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(m, 16)).astype(np.float32)
    tok = np.abs(_tokens(d, seed=4))          # -1 pads carry no gradient
    cot = rng.normal(size=tok.shape + (16,)).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_()
    out = ops.bloom_embed(tt, torch.from_numpy(tok).long(), spec,
                          bwd_impl=bwd_impl, table_dtype=td,
                          out_dtype=None if td is None else torch.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda t: jnp.sum(jops.bloom_embed(
        t, jnp.asarray(tok), jspec, bwd_impl=bwd_impl, table_dtype=td,
        out_dtype=None if td is None else jnp.float32) * cot))(
            jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_variant_names_follow_the_spec_kind():
    hashed, fixed = BloomSpec(d=100, m=20, k=2), BloomSpec(
        d=100, m=20, k=2, on_the_fly=False)
    ident = bloom.identity_spec(50)
    assert [be.spec_kind(s) for s in (hashed, fixed, ident)] == \
        ["hash", "H", "id"]
    assert be.token_variant_name(hashed) == "bloom_embed.hash"
    assert be.token_variant_name(fixed, torch.int8) == "bloom_embed.int8.H"
    assert be.token_variant_name(ident, torch.float8_e4m3fn) == \
        "bloom_embed.fp8_e4m3.id"


def test_token_entry_checks_on_cuda_without_a_gpu():
    spec = BloomSpec(d=100, m=20, k=2)
    with pytest.raises(ValueError, match="CUDA device"):
        be.bloom_embed_tokens_cuda(torch.zeros(20, 8),
                                   torch.zeros(3, dtype=torch.int64), spec)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        be.bloom_embed_tokens_cuda(torch.zeros(20, 8, dtype=torch.int8),
                                   torch.zeros(3, dtype=torch.int64), spec)
    with pytest.raises(ValueError, match="scales"):
        be.bloom_embed_tokens_quantized_cuda(
            torch.zeros(20, 8, dtype=torch.int8), None,
            torch.zeros(3, dtype=torch.int64), spec)


def test_precomputed_hash_matrix_is_built_once_per_spec_and_device():
    spec = BloomSpec(d=700, m=64, k=3, seed=11, on_the_fly=False)
    ids = torch.arange(-3, 703)
    bloom._cached_hash_matrix.cache_clear()
    a = spec.indices_for(ids)
    b = spec.indices_for(ids[:5])
    info = bloom._cached_hash_matrix.cache_info()
    assert info.misses == 1 and info.hits == 1
    H = hashing.make_hash_matrix(700, 3, 64, 11)
    assert torch.equal(a, H[ids.clamp(0, 699)]) and torch.equal(b, a[:5])


# --- the embed kernel's in-kernel hash (csrc/bloom_hash.cuh) in numpy -----

def _fastmod(n, d):
    mp, sh = common.magic_divisor(d)
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(mp)) >> np.uint64(32)
    q = (t + ((n - t) >> np.uint64(sh & 0xFF))) >> np.uint64(sh >> 8)
    return n - q * np.uint64(d)


def _splitmix32(z):
    mask = np.uint64(0xFFFFFFFF)
    z = (z + np.uint64(0x9E3779B9)) & mask
    z = ((z ^ (z >> np.uint64(16))) * np.uint64(0x85EBCA6B)) & mask
    z = ((z ^ (z >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & mask
    return z ^ (z >> np.uint64(16))


def _kernel_hash(ids, k, m, seed):
    """bloom_hash::h1h2 and hash_j: h1, h2 by the magic remainders, then
    h_j = (h1 + j*h2 + (j^3 - j)/6 % m) % m with the sum wrapping in uint32
    and its remainder by the magic constants."""
    c1, c2, *_ = common.hash_constants(m, seed)
    mask = np.uint64(0xFFFFFFFF)
    i = np.asarray(ids, dtype=np.int64).astype(np.uint64) & mask
    h1 = _fastmod(_splitmix32(i ^ np.uint64(c1)), m)
    h2 = _fastmod(_splitmix32(i ^ np.uint64(c2)), max(m - 1, 1)) + 1
    out = []
    for j in range(k):
        tri = (j ** 3 - j) // 6 % m
        s = (h1 + np.uint64(j) * h2 + np.uint64(tri)) & mask
        out.append(_fastmod(s, m))
    return np.stack(out, axis=-1).astype(np.int64)


@pytest.mark.parametrize("m", [1, 2, 3, 30208, 2 ** 31 - 1])
def test_kernel_hash_equals_double_hash(m):
    rng = np.random.default_rng(m % 1000)
    ids = np.concatenate([np.arange(-40, 40), [151_935, 2 ** 31 - 1,
                                               -2 ** 31],
                          rng.integers(-2 ** 31, 2 ** 31, 20_000)])
    for k in range(1, min(8, m) + 1):
        want = hashing.double_hash(torch.from_numpy(ids), k, m, 9).numpy()
        np.testing.assert_array_equal(_kernel_hash(ids, k, m, 9), want)


# --- the Eq. 3 decode forward's launch plan ------------------------------

@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_decode_plan_fits_shared_memory_for_every_m(itemsize):
    for m in range(1, bd.MAX_M + 1):
        pl = bd.plan(8, m, 151_936, 4, itemsize, 132)
        assert pl.smem == 4 * m
        assert pl.smem + bd.SMEM_STATIC <= bd.SMEM_LIMIT
    with pytest.raises(ValueError):
        bd.plan(8, bd.MAX_M + 1, 100, 4, itemsize, 132)


@pytest.mark.parametrize("B", [1, 3, 8, 13, 300])
@pytest.mark.parametrize("d", [1, 7, 2049, 151_936, 1_000_003])
@pytest.mark.parametrize("n_sm", [1, 7, 132])
def test_decode_plan_covers_every_row_and_id_once(B, d, n_sm):
    for itemsize in (4, 2, 1):
        pl = bd.plan(B, 1000, d, 3, itemsize, n_sm)
        assert pl.rows == 4 // itemsize and pl.chunk % 4 == 0
        assert pl.grid == pl.tiles * pl.groups and pl.grid < 2 ** 31
        if pl.tiles <= n_sm:
            assert pl.grid <= max(n_sm, pl.tiles)
        # the kernel's block -> (tile, id range) map, as the kernel reads it
        seen_rows = np.zeros(B, np.int64)
        seen_ids = np.zeros(d, np.int64)
        for unit in range(pl.grid):
            t, g = unit % pl.tiles, unit // pl.tiles
            if g == 0:
                seen_rows[t * pl.rows:min(B, t * pl.rows + pl.rows)] += 1
            if t == 0:
                seen_ids[g * pl.chunk:min(d, g * pl.chunk + pl.chunk)] += 1
        assert (seen_rows == 1).all() and (seen_ids == 1).all()
        assert pl.tiles * pl.rows - B < pl.rows


def test_decode_reads_h_packed_to_16_bits():
    """pack_h keeps every index below 2**16 (m <= MAX_M) as its low 16
    bits; the spec's packed matrix is built once, beside the matrix."""
    H = torch.tensor([[0, 1, 32767], [32768, 57343, bd.MAX_M - 1]],
                     dtype=torch.int32)
    packed = bd.pack_h(H)
    assert packed.dtype == torch.int16
    assert torch.equal(packed.to(torch.int32) & 0xFFFF, H)
    spec = BloomSpec(d=bd.MAX_M + 900, m=bd.MAX_M, k=3, seed=2)
    bloom._cached_packed_hash_matrix.cache_clear()
    a = bloom.cached_packed_hash_matrix(spec, "cpu")
    assert a is bloom.cached_packed_hash_matrix(spec, torch.device("cpu"))
    assert torch.equal(a.to(torch.int32) & 0xFFFF,
                       bloom.cached_hash_matrix(spec, "cpu"))
