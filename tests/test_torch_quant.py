"""The quantized-table (``table_dtype``) modules of the port against the JAX
package, on the same numpy inputs: ``core.quant`` (bit-equal int8 ``q`` and
scales, bf16 casts, and fp8 equal after dequantize with NaN at the same
places), ``core.bloom.cached_quantized_table``, the quantized Bloom embed
forward (``kernels.bloom_embed``) against ``bloom_embed_pallas(table_dtype
=...)`` and ``bloom_embed_fwd_quantized`` in interpret mode, its
straight-through gradient against ``jax.grad``, and the narrow-logp,
in-kernel-hash decode-top-k (``kernels.bloom_decode_topk``) against
``bloom_decode_topk_pallas(table_dtype=..., hash_spec=...)`` in interpret
mode and the reference's materialized oracle.

Tolerances: the embed within atol 1e-6 in f32 (the reference may sum the k
rows in another order) and within one bf16 ulp in bf16 (that order can
round to the neighbouring bf16 value); the gradient within 1e-4 (the
reference's own tolerance for gradients).  The decode's ids and scores
equal exactly the top-k of the reference's materialized Eq. 3 scores over
its own dequantized rows (``ref.bloom_decode_ref`` + ``lax.top_k``, lowest
id first on ties); the reference's Pallas kernel is held to the same within
1e-6, its ids through those scores, because its compiled fusions move
exactly tied int8 sums by an ulp from one compilation to the next, as the
reference's own tests note.  On the CPU every entry takes the plain
version and launches nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.bloom import BloomSpec as JSpec
from repro.core.bloom import cached_hash_matrix as j_cached_hash_matrix
from repro.core.bloom import identity_spec as j_identity_spec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bloom_decode_topk import bloom_decode_topk_pallas
from repro.kernels.bloom_decode_topk import \
    modeled_hbm_bytes as j_modeled_hbm_bytes
from repro.kernels.bloom_embed import (bloom_embed_fwd_quantized,
                                       bloom_embed_pallas)
from repro_torch.core import hashing, quant
from repro_torch.core.bloom import (BloomSpec, cached_hash_matrix,
                                    cached_quantized_table, identity_spec)
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common, ops

TDS = list(quant.TABLE_DTYPES)
FP8_EDGES = [0.0, 448.0, -448.0, 464.0, -464.0, 464.0001, -464.0001, 500.0,
             -500.0, np.inf, -np.inf, 1e-9, 0.0009765625, 0.00146484375]


def _table(m, D, seed=0):
    """Rows of very different ranges, an all-zero row, and a row whose
    int8 values land on .5 ties (max 127, so the scale is exactly 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, D)) * np.exp(rng.uniform(-6, 4, size=(m, 1)))
    x = x.astype(np.float32)
    x[1] = 0.0
    x[2] = 0.0
    x[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    return x


def _bits(t):
    """Stored values as comparable numpy: raw bytes for the 1-byte dtypes,
    f32 values otherwise."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8).numpy() if t.element_size() == 1
                else t.float().numpy())
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else \
        np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("td", TDS)
def test_quantize_table_bit_equal_to_the_reference(td):
    x = _table(40, 33)
    jq, js = jquant.quantize_table(jnp.asarray(x), td)
    tq, ts = quant.quantize_table(torch.from_numpy(x), td)
    assert tq.dtype == quant.storage_dtype(td)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    assert (ts is None) == (js is None) == (td != "int8")
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert np.all(tq.numpy()[1] == 0)                 # all-zero row
        np.testing.assert_array_equal(tq.numpy()[2, :6],
                                      [127, 0, 2, 2, 0, -2])  # half to even
    np.testing.assert_array_equal(
        quant.dequantize_table(tq, ts).numpy(),
        np.asarray(jquant.dequantize_table(jq, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_gives_nan_where_the_reference_does(dtype):
    x = np.asarray(FP8_EDGES, np.float32)[None, :]
    jq, _ = jquant.quantize_table(jnp.asarray(x).astype(dtype), "fp8_e4m3")
    tq, _ = quant.quantize_table(
        torch.from_numpy(x).to(getattr(torch, dtype)), "fp8_e4m3")
    want = np.asarray(jquant.dequantize_table(jq, None))
    got = quant.dequantize_table(tq, None).numpy()
    np.testing.assert_array_equal(got, want)     # NaN == NaN here
    xs = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    assert np.array_equal(np.isnan(got), np.abs(xs) > 464)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))


def test_knob_names_sizes_and_validation():
    assert quant.resolve_table_dtype("fp8") == "fp8_e4m3"
    assert quant.resolve_table_dtype("auto", allow_auto=True) == "auto"
    with pytest.raises(ValueError, match="table_dtype must be one of"):
        quant.resolve_table_dtype("int4")
    for td in TDS:
        assert quant.table_itemsize(td) == jquant.table_itemsize(td)
        assert quant.storage_name(quant.storage_dtype(td)) == td
        assert quant.storage_dtype(td).itemsize == quant.table_itemsize(td)
    with pytest.raises(TypeError):
        quant.storage_name(torch.float64)


def test_cached_quantized_table_hits_only_the_same_unmodified_table():
    spec = BloomSpec(d=300, m=16, k=2, seed=5)
    table = torch.randn(16, 8)
    q, s = cached_quantized_table(spec, table, "int8")
    assert cached_quantized_table(spec, table, "int8")[0] is q
    assert cached_quantized_table(spec, table.clone(), "int8")[0] is not q
    q2, _ = cached_quantized_table(spec, table, "int8")
    with torch.no_grad():
        table.mul_(2.0)                 # an in-place update, as training does
    q3, s3 = cached_quantized_table(spec, table, "int8")
    assert q3 is not q2 and torch.equal(s3, 2 * s)
    fp8, none = cached_quantized_table(spec, table, "fp8_e4m3")
    assert none is None and fp8.dtype == torch.float8_e4m3fn
    with torch.inference_mode():
        t_inf = torch.randn(16, 8)
        a = cached_quantized_table(spec, t_inf, "int8")[0]
        assert cached_quantized_table(spec, t_inf, "int8")[0] is not a


def _embed_inputs(T, k, m, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, D)).astype(np.float32),
            rng.integers(0, m, size=(T, k)).astype(np.int32))


def _ulp_bf16(x):
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.where(x == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))


def _assert_embed_close(got, want, out_dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _ulp_bf16(want)), \
            np.abs(got - want).max()


@pytest.mark.parametrize("T,k,m,D", [(7, 3, 64, 48), (19, 4, 96, 37),
                                     (1, 4, 512, 1024), (8, 1, 32, 64)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("td", TDS)
def test_quantized_embed_plain_matches_pallas(td, out_dtype, T, k, m, D):
    table, idx = _embed_inputs(T, k, m, D)
    q, s = quant.quantize_table(torch.from_numpy(table), td)
    got = be.bloom_embed_quantized_plain(q, s, torch.from_numpy(idx),
                                         getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (T, D)
    jod = getattr(jnp, out_dtype)
    _assert_embed_close(got, bloom_embed_pallas(
        jnp.asarray(table), jnp.asarray(idx), d_tile=256, interpret=True,
        table_dtype=td, out_dtype=jod), out_dtype)
    jq, js = jquant.quantize_table(jnp.asarray(table), td)
    _assert_embed_close(got, bloom_embed_fwd_quantized(
        jq, js, jnp.asarray(idx), d_tile=256, interpret=True,
        out_dtype=jod), out_dtype)
    # the autograd entry and the serving entry take the same plain version
    common.reset_launches()
    ent = be.bloom_embed(torch.from_numpy(table), torch.from_numpy(idx),
                         table_dtype=td, out_dtype=getattr(torch, out_dtype))
    assert torch.equal(ent, got) and common.LAUNCHES == {}
    assert torch.equal(be.bloom_embed_fwd_quantized(
        q, s, torch.from_numpy(idx), getattr(torch, out_dtype)), got)


@pytest.mark.parametrize("td", TDS)
def test_quantized_embed_default_out_dtype_matches_the_reference(td):
    table = torch.randn(8, 4)
    out = be.bloom_embed(table, torch.zeros((2, 2), dtype=torch.int32),
                         table_dtype=td)
    want = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.float32, "fp8_e4m3": torch.float32}[td]
    assert out.dtype == want == be.default_out_dtype(td, table)
    assert be.default_out_dtype(None, table.bfloat16()) == torch.bfloat16


def test_plain_int8_sums_the_scaled_rows_in_j_order():
    """Each int8 row is q * scale, rounded on its own, then added in j
    order from row 0 in f32 and rounded once."""
    q = torch.tensor([[100], [1], [-100]], dtype=torch.int8)
    s = torch.tensor([2.0 ** 20, 0.75, 2.0 ** 20])
    out = be.bloom_embed_quantized_plain(
        q, s, torch.tensor([[0, 1, 2]], dtype=torch.int32), torch.float32)
    assert out.item() == 0.0        # (a + 0.75) rounds to a, then - a
    out = be.bloom_embed_quantized_plain(
        q, s, torch.tensor([[0, 2, 1]], dtype=torch.int32), torch.float32)
    assert out.item() == 0.75


@pytest.mark.parametrize("td", ["int8", "fp8_e4m3"])
def test_quantized_embed_grad_is_straight_through_like_jax_grad(td):
    """ops.bloom_embed with a table that wants a gradient quantizes in the
    graph; its gradient equals the reference's jax.grad through the
    quantized Pallas forward (CSR backward) within 1e-4."""
    spec, jspec = BloomSpec(d=500, m=64, k=3, seed=2), \
        JSpec(d=500, m=64, k=3, seed=2)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(64, 32)).astype(np.float32)
    tokens = rng.integers(0, 500, size=(3, 5)).astype(np.int32)
    cot = rng.normal(size=(3, 5, 32)).astype(np.float32)

    def f(tbl):
        out = jops.bloom_embed(tbl, jnp.asarray(tokens), jspec,
                               table_dtype=td, out_dtype=jnp.float32)
        return jnp.vdot(out, jnp.asarray(cot))

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = ops.bloom_embed(t, torch.from_numpy(tokens), spec, table_dtype=td,
                          out_dtype=torch.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    assert t.grad.dtype == torch.float32
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-4)
    # and the forward is the quantized one, as the reference's
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jops.bloom_embed(jnp.asarray(table), jnp.asarray(tokens),
                                    jspec, table_dtype=td,
                                    out_dtype=jnp.float32)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("td", TDS)
def test_ops_embed_without_grad_uses_the_cached_table(td):
    spec, jspec = BloomSpec(d=400, m=48, k=4, seed=1), \
        JSpec(d=400, m=48, k=4, seed=1)
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(48, 24)).astype(np.float32))
    tokens = rng.integers(0, 400, size=(2, 6)).astype(np.int32)
    with torch.inference_mode():
        got = ops.bloom_embed(table, torch.from_numpy(tokens), spec,
                              table_dtype=td)
    assert got.dtype == torch.float32          # the reference's default
    q = cached_quantized_table(spec, table, td)[0]
    assert cached_quantized_table(spec, table, td)[0] is q
    want = jops.bloom_embed(jnp.asarray(table.numpy()), jnp.asarray(tokens),
                            jspec, table_dtype=td)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_embed_wrapper_checks():
    q, s = quant.quantize_table(torch.randn(8, 4), "int8")
    idx = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        be.bloom_embed_quantized_plain(q, None, idx)
    with pytest.raises(ValueError, match="scales"):
        be.bloom_embed_quantized_plain(q.float(), s, idx)
    with pytest.raises(TypeError, match="out_dtype"):
        be.bloom_embed_quantized_plain(q, s, idx, torch.float16)
    with pytest.raises(ValueError, match="needs a table_dtype"):
        be.bloom_embed(torch.randn(8, 4), idx, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        be.bloom_embed_quantized_cuda(q, s, idx)
    assert be.variant_name(torch.int8) == "bloom_embed.int8"
    assert be.min_bytes(3, 8, 4, 1024, 1, out_itemsize=2,
                        row_scales=True) == \
        3 * 1024 + 3 * 4 + 8 * 4 * 4 + 8 * 1024 * 2


def _logp(B, m, seed=0):
    rng = np.random.default_rng(seed)
    return np.array(jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(B, m)).astype(np.float32)), axis=-1))


def _pallas(logp, H, topk, td, hash_spec=None, active=None):
    v, i = bloom_decode_topk_pallas(
        jnp.asarray(logp), None if H is None else jnp.asarray(H), topk,
        b_tile=4, v_tile=64, interpret=True, table_dtype=td,
        hash_spec=hash_spec,
        active=None if active is None else jnp.asarray(active))
    return np.asarray(v), np.asarray(i)


def _assert_topk_like_the_reference(got, pallas, logp, H, td, topk,
                                    rows=slice(None)):
    """``got`` (port) equals the top-k of the reference's materialized
    scores exactly; the reference kernel's output ``pallas`` agrees with
    them within 1e-6 (values, and its ids scored through them)."""
    q, s = jquant.quantize_table(jnp.asarray(logp), td)
    scores = jref.bloom_decode_ref(jquant.dequantize_table(q, s),
                                   jnp.asarray(H))
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(scores, topk))
    got_v, got_i = (t.numpy()[rows] for t in got)
    np.testing.assert_array_equal(got_i, want_i[rows])
    np.testing.assert_array_equal(got_v, want_v[rows])
    pv, pi = (a[rows] for a in pallas)
    np.testing.assert_allclose(pv, got_v, rtol=0, atol=1e-6)
    picked = np.take_along_axis(np.asarray(scores)[rows], pi, axis=-1)
    np.testing.assert_allclose(picked, got_v, rtol=0, atol=1e-6)


@pytest.mark.parametrize("live", [None, [1, 0, 0, 1, 0, 1, 1, 0]])
@pytest.mark.parametrize("hashed", [True, False])
@pytest.mark.parametrize("td", TDS)
def test_quantized_decode_plain_matches_pallas(td, hashed, live):
    B, m, d, k, topk, seed = 8, 64, 333, 3, 8, 7
    logp = _logp(B, m)
    spec = BloomSpec(d=d, m=m, k=k, seed=seed)
    H = cached_hash_matrix(spec, "cpu")
    q, s = quant.quantize_table(torch.from_numpy(logp), td)
    act = None if live is None else np.asarray(live, bool)
    hs = (d, k, seed) if hashed else None
    got = dt.bloom_decode_topk_plain(
        q, None if hashed else H, topk,
        None if act is None else torch.from_numpy(act), s, hs)
    pallas = _pallas(logp, None if hashed else H.numpy(), topk, td, hs, act)
    _assert_topk_like_the_reference(
        got, pallas, logp, j_cached_hash_matrix(JSpec(d=d, m=m, k=k,
                                                      seed=seed)),
        td, topk, slice(None) if act is None else act)
    if act is not None:
        assert np.all(got[1].numpy()[~act] == 0)
        assert np.all(np.isneginf(got[0].numpy()[~act]))
    # the in-kernel hash and the cached matrix rank the same ids
    other = dt.bloom_decode_topk_plain(q, H if hashed else None, topk,
                                       None if act is None else
                                       torch.from_numpy(act), s,
                                       None if hashed else (d, k, seed))
    assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1])


@pytest.mark.parametrize("d,m,k,seed", [(333, 64, 3, 7), (5000, 97, 4, 0),
                                        (1000, 2, 2, 3), (151936, 30208, 4,
                                                          0)])
def test_inkernel_hash_indices_equal_the_cached_hash_matrix(d, m, k, seed):
    """The hash the kernel re-derives (core.hashing.double_hash, written
    out in the kernel incrementally: h_j = h_{j-1} + h2 + j(j-1)/2 mod m)
    equals cached_hash_matrix of the on-the-fly spec, which equals the
    reference's."""
    spec = BloomSpec(d=d, m=m, k=k, seed=seed)
    ids = torch.arange(d, dtype=torch.int64)
    H = hashing.double_hash(ids, k, m, seed)
    assert torch.equal(H, cached_hash_matrix(spec, "cpu"))
    np.testing.assert_array_equal(
        H.numpy(), np.asarray(j_cached_hash_matrix(JSpec(d=d, m=m, k=k,
                                                         seed=seed))))
    # the kernel's incremental form, in int64 with the same conditional
    # subtractions
    c1, c2 = hashing.double_hash_salts(seed)
    x = hashing.splitmix32(ids ^ c1) % m
    h2 = hashing.splitmix32(ids ^ c2) % max(m - 1, 1) + 1
    cols = [x]
    for j in range(1, k):
        x = x + h2
        x = torch.where(x >= m, x - m, x)
        x = x + (j * (j - 1) // 2) % m
        x = torch.where(x >= m, x - m, x)
        cols.append(x)
    assert torch.equal(torch.stack(cols, -1).to(torch.int32), H)


@pytest.mark.parametrize("td", TDS)
def test_ops_decode_routes_like_the_reference(td):
    """ops.bloom_decode_topk with a table_dtype: the in-kernel hash for an
    on-the-fly spec, the cached matrix for an identity spec; both equal the
    reference's ops on the CPU and launch nothing."""
    logp = _logp(6, 64, seed=3)
    for spec, jspec in ((BloomSpec(d=700, m=64, k=2, seed=4),
                         JSpec(d=700, m=64, k=2, seed=4)),
                        (identity_spec(64), j_identity_spec(64))):
        lp = torch.from_numpy(logp).reshape(2, 3, 64)
        common.reset_launches()
        v, i = ops.bloom_decode_topk(lp, spec, 5, table_dtype=td)
        assert common.LAUNCHES == {} and v.shape == i.shape == (2, 3, 5)
        jv, ji = jops.bloom_decode_topk(jnp.asarray(logp).reshape(2, 3, 64),
                                        jspec, 5, table_dtype=td)
        _assert_topk_like_the_reference(
            (v.reshape(6, 5), i.reshape(6, 5)),
            (np.asarray(jv).reshape(6, 5), np.asarray(ji).reshape(6, 5)),
            logp, j_cached_hash_matrix(jspec), td, 5)


def test_decode_wrapper_checks_and_names():
    logp = torch.zeros(2, 8)
    q, s = quant.quantize_table(logp, "int8")
    H = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one of H and hash_spec"):
        dt.bloom_decode_topk(logp, H, 2, hash_spec=(5, 2, 0))
    with pytest.raises(ValueError, match="exactly one of H and hash_spec"):
        dt.bloom_decode_topk(logp, None, 2)
    with pytest.raises(ValueError, match="scales"):
        dt.bloom_decode_topk(q, H, 2)
    with pytest.raises(ValueError, match="scales"):
        dt.bloom_decode_topk(logp, H, 2, scales=s)
    with pytest.raises(TypeError, match="stored as"):
        dt.bloom_decode_topk(logp.double(), H, 2)
    with pytest.raises(ValueError, match="1 <= k <= m"):
        dt.bloom_decode_topk(logp, None, 2, hash_spec=(5, 9, 0))
    with pytest.raises(ValueError, match="CUDA device"):
        dt.bloom_decode_topk_cuda(q, None, 2, scales=s, hash_spec=(5, 2, 0))
    assert dt.variant_name(torch.float32, False) == "bloom_decode_topk"
    assert dt.variant_name(torch.int8, True) == "bloom_decode_topk.int8.hash"
    assert dt.variant_name(torch.int8, False) == "bloom_decode_topk.int8"
    assert dt.variant_name(torch.float32, True) == \
        "bloom_decode_topk.float32.hash"
    assert dt.hash_ops(10, 2) == 10 * 27 and dt.hash_ops(10, 4) == 10 * 35


@pytest.mark.parametrize("td", [None] + TDS)
def test_bytes_models_follow_the_knob(td):
    live = np.array([1, 0, 1, 1, 0, 0, 0, 0], bool)
    kw = dict(m=256, d=50_000, k=2, topk=8,
              logp_itemsize=quant.table_itemsize(td),
              inkernel_hash=td is not None, row_scales=td == "int8")
    assert dt.modeled_hbm_bytes(live, 4, **kw) == \
        j_modeled_hbm_bytes(live, 4, **kw)
    assert dt.min_bytes(3, 8, **kw) == (
        (0 if td else 50_000 * 2 * 4)
        + 3 * (256 * quant.table_itemsize(td) + (4 if td == "int8" else 0))
        + 8 * 8 * 8)
