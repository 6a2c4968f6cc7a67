"""A narrow Bloom table (``table_dtype``) under a model axis, in one process,
against the JAX package on the same numpy inputs.

Each rank of a vocab-parallel embedding holds the rows [lo, lo + m / n) of
the table and quantizes them itself; ``core/quant.py`` quantizes row by
row, so a shard's stored rows and int8 scales are the whole table's rows
[lo, lo + m / n) bit for bit (the reference's ``quantize_table`` on the
whole table, the fp8 NaN rule included).  The sum over 2 and 4 ranks of
each rank's ranged, quantized gather-sum (the embed kernel's plain
version, the CPU path) equals the reference's ``models/io.embed_tokens``
with ``io_impl="pallas"`` and that ``table_dtype`` (its Pallas kernel in
interpret mode) within atol 1e-6 on a unit-scale table (the model's):
the ranks' parts are summed in another order than one kernel's k rows.
Each shard's straight-through gradient equals its rows of ``jax.grad``
through the reference's quantized forward within 1e-4 (the reference's
own tolerance for gradients).  The
forward-only (serving) branch of ``ops.bloom_embed`` quantizes the shard
once (``core.bloom.cached_quantized_table``) and gathers from it with the
row range, bit for bit the plain ranged gather-sum.  The 2x2 gloo run of
an int8 model is in tests/test_torch_zero.py (one spawn for both)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quant as jquant
from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.models import io as j_io
from repro_torch import configs as tconfigs
from repro_torch.core import quant
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import sharding
from repro_torch.launch.mesh import counting_mesh
from repro_torch.models import io as t_io

TDS = ["int8", "bfloat16", "fp8_e4m3"]
FP8_EDGES = [0.0, 448.0, -448.0, 464.0, -464.0, 464.0001, 500.0, np.inf,
             -np.inf, 1e-9]


def _bits(t):
    """Stored values as comparable numpy: raw bytes for 1-byte dtypes,
    f32 values otherwise."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8).numpy() if t.element_size() == 1
                else t.float().numpy())
    a = np.asarray(t)
    return (a.view(np.uint8) if a.dtype.itemsize == 1
            else np.asarray(jnp.asarray(t, jnp.float32)))


def _table(m, D, seed):
    """Rows of very different ranges, an all-zero row, and fp8's edge
    values (NaN past 464) in the last row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, D)) * np.exp(rng.uniform(-6, 4, size=(m, 1)))
    x = x.astype(np.float32)
    x[1] = 0.0
    x[-1, :len(FP8_EDGES)] = FP8_EDGES
    return x


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("td", TDS)
def test_a_shards_quantized_rows_are_the_whole_tables(td, n):
    """Every rank's ``quantize_table`` of its rows equals the reference's
    quantization of the whole table at those rows, bit for bit (int8
    values and scales, bf16 and fp8 bytes; NaN where the reference has
    it)."""
    x = _table(64, 24, seed=1)
    jq, js = jquant.quantize_table(jnp.asarray(x), td)
    jq, js = _bits(jq), None if js is None else np.asarray(js)
    rows = 64 // n
    for r in range(n):
        lo = r * rows
        tq, ts = quant.quantize_table(torch.from_numpy(x[lo:lo + rows]), td)
        np.testing.assert_array_equal(_bits(tq), jq[lo:lo + rows])
        assert (ts is None) == (js is None)
        if ts is not None:
            np.testing.assert_array_equal(ts.numpy(), js[lo:lo + rows])
    if td == "fp8_e4m3":
        last = quant.dequantize_table(*quant.quantize_table(
            torch.from_numpy(x[-rows:]), td)).numpy()[-1]
        assert np.array_equal(np.isnan(last[:len(FP8_EDGES)]),
                              np.abs(FP8_EDGES) > 464)


def _configs(td):
    """qwen1.5-0.5b smoke (m 128, d_model 64, k 3, f32) with ``td``: the
    reference's on its Pallas IO path, and the port's."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen1.5-0.5b"),
                               io_impl="pallas", table_dtype=td,
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("qwen1.5-0.5b"),
                               table_dtype=td, dtype="float32")
    return jcfg, tcfg


@pytest.mark.parametrize("td", TDS)
def test_the_ranks_parts_sum_to_the_references_embed(td):
    """The sum over 2 and over 4 ranks of each rank's ranged quantized
    gather-sum, from (B, S) tokens with ids 0 and d - 1, equals the
    reference's ``embed_tokens`` (``io_impl="pallas"``) within 1e-6; so
    does ``io.embed_tokens`` on the rank of a counting mesh, whose part
    is the same tensor (the counting transport sums nothing)."""
    jcfg, tcfg = _configs(td)
    m, D = tcfg.m_vocab, tcfg.d_model
    # unit-scale rows, as the model draws its table: the parts' other sum
    # order moves a sum of k such rows by an f32 ulp or two
    table = np.random.default_rng(2).normal(size=(m, D)).astype(np.float32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab, size=(3, 7)).astype(np.int32)
    tokens[0, :2] = [0, tcfg.vocab - 1]
    want = np.asarray(j_io.embed_tokens({"embed": jnp.asarray(table)},
                                        jcfg, jnp.asarray(tokens)))
    spec = t_io.vocab_spec(tcfg)
    flat = torch.from_numpy(tokens).reshape(-1)
    for n in (2, 4):
        rows, total = m // n, 0.0
        for r in range(n):
            lo = r * rows
            shard = torch.from_numpy(table[lo:lo + rows])
            q, s = quant.quantize_table(shard, td)
            part = be.bloom_embed_tokens_plain(q, s, flat, spec,
                                               torch.float32, lo)[0]
            mesh = counting_mesh((1, n))
            mesh = dataclasses.replace(mesh, rank=r)
            via_io = t_io.embed_tokens(shard, tcfg,
                                       torch.from_numpy(tokens),
                                       sharding.DistContext(mesh))
            assert torch.equal(via_io.reshape(part.shape), part)
            total = total + part
        np.testing.assert_allclose(total.numpy().reshape(want.shape), want,
                                   rtol=0, atol=1e-6, err_msg=f"n={n}")


@pytest.mark.parametrize("td", TDS)
def test_each_shards_gradient_is_its_rows_of_jax_grad(td):
    """``ops.bloom_embed`` on a rank's rows with ``table_dtype`` and
    ``lo`` quantizes the shard in the graph; its gradient (CSR and
    dense) is straight-through into the shard's f32 master rows and
    equals those rows of ``jax.grad`` through the reference's quantized
    forward within 1e-4."""
    spec, jspec = (BloomSpec(d=500, m=64, k=3, seed=2),
                   JSpec(d=500, m=64, k=3, seed=2))
    rng = np.random.default_rng(3)
    table = rng.normal(size=(64, 32)).astype(np.float32)
    tokens = rng.integers(0, 500, size=(3, 5)).astype(np.int32)
    cot = rng.normal(size=(3, 5, 32)).astype(np.float32)

    def f(tbl):
        out = jops.bloom_embed(tbl, jnp.asarray(tokens), jspec,
                               table_dtype=td, out_dtype=jnp.float32)
        return jnp.vdot(out, jnp.asarray(cot))

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    for n in (2, 4):
        rows = 64 // n
        for r in range(n):
            lo = r * rows
            for bwd in ("csr", "dense"):
                shard = torch.from_numpy(table[lo:lo + rows].copy())
                shard.requires_grad_()
                out = ops.bloom_embed(shard, torch.from_numpy(tokens), spec,
                                      bwd_impl=bwd, table_dtype=td,
                                      out_dtype=torch.float32, lo=lo)
                (out * torch.from_numpy(cot)).sum().backward()
                assert shard.grad.dtype == torch.float32
                np.testing.assert_allclose(
                    shard.grad.numpy(), want[lo:lo + rows], rtol=0,
                    atol=1e-4, err_msg=f"n={n} r={r} {bwd}")


@pytest.mark.parametrize("td", TDS)
def test_the_serving_branch_takes_the_row_range(td):
    """Under ``torch.no_grad()`` ``ops.bloom_embed`` with ``lo`` takes the
    forward-only branch: the shard's quantized copy from
    ``cached_quantized_table`` (one entry for this process's shard,
    reused by the next call) and the ranged gather-sum over it, equal to
    the plain version on the shard's own quantization bit for bit."""
    spec = BloomSpec(d=300, m=48, k=4, seed=7)
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 300, size=(2, 9)))
    lo, rows = 24, 24
    shard = table[lo:lo + rows].clone()
    q, s = quant.quantize_table(shard, td)
    want = be.bloom_embed_tokens_plain(q, s, tokens.reshape(-1), spec,
                                       torch.float32, lo)[0]
    with torch.no_grad():
        for _ in range(2):
            got = ops.bloom_embed(shard, tokens, spec, table_dtype=td, lo=lo)
            assert got.dtype == torch.float32
            assert torch.equal(got.reshape(want.shape), want)
    from repro_torch.core.bloom import _QUANT_CACHE
    assert _QUANT_CACHE[(spec, td, "cpu")][0] is shard


@pytest.mark.parametrize("td", TDS)
def test_the_dry_run_counts_the_ranged_quantized_entry(td):
    """On ``meta`` tensors (the dry run), a rank's quantized ranged embed
    counts as the kernel ``bloom_embed.<storage>.hash.range``: one call
    at its least bytes, the shard's gathered rows at the stored width."""
    spec = BloomSpec(d=300, m=48, k=4, seed=7)
    shard = torch.empty(24, 16, device="meta", requires_grad=True)
    tokens = torch.empty(2, 9, dtype=torch.long, device="meta")
    counter = dryrun.StepCounter(((shard, tokens),))
    with counter:
        ops.bloom_embed(shard, tokens, spec, table_dtype=td,
                        out_dtype=torch.float32, lo=24)
    st = quant.storage_dtype(td)
    name = be.token_variant_name(spec, st) + be.RANGE
    assert name == f"bloom_embed.{quant.storage_name(st)}.hash.range"
    assert counter.kernels[name]["count"] == 1
    assert counter.kernels[name]["bytes"] == be.min_bytes(
        min(18 * 4, 24), 18, 4, 16, st.itemsize, 4, td == "int8", 8) \
        + 18 * 4 * 4
