"""Kernel bench of the port, the twin of ``benchmarks/bench_kernels.py``:
the Bloom kernel suite (embed forward on every storage, both embed
backwards, the CE pair, the Eq. 3 decode and both of its backwards, the
fused decode-top-k on every storage, its row-skipping grid and the
compacted pool) at the reference's three production IO shapes
(``_cases``: qwen3-4b, qwen1.5-0.5b, pixtral-12b).

It builds the same 69 rows, under the same names and in the same order,
as the committed ``BENCH_kernels.json``.  Each row couples two parts:

* the reference's analytic byte model at the PRODUCTION shape (``bytes``,
  ``bytes_ideal``, ``table_bytes``, the slot and block counts, the
  rounded ratios; ``tokens`` and the ``check_*`` shapes beside them).
  These model the reference's TPU grids, not the port's kernels, and are
  computed by the reference's formulas (the two CSR models are copied
  below; the decode-top-k one is ``kernels/bloom_decode_topk.
  modeled_hbm_bytes``), so they equal the committed rows integer for
  integer;
* ``max_err``: the row's port route (the public entries of
  ``kernels/ops.py``, differentiated by autograd for the backward rows)
  against the port's oracle (``kernels/ref.py``, ``core/losses.py``) at
  the reference's check shapes, on random inputs drawn on the device by a
  ``torch.Generator`` seeded 0 per shape.  On a CUDA device the route
  launches the hand-written kernels (a build or launch failure raises);
  on the CPU it takes their plain twins.

The reference's ``tpu_us_model`` (bytes over a TPU's HBM rate) becomes
``h100_us_bound``: the least bytes the port's kernel must move at the
production shape (its module's ``min_bytes``) over the H100 SXM's HBM3
rate, ``launch/roofline.HBM_BW`` (3.35 TB/s).  It is the only field that
differs in kind from the committed row.

``--check`` holds the rows to ``BENCH_kernels.json`` (read only, never
written) with every gate of the reference's ``check_against``, and also
fails when a row's fields are not the committed row's (``tpu_us_model``
swapped for ``h100_us_bound``) or one of them differs from the committed
value (all but ``max_err``, held within ``err_slack``).  ``--measure``
(CUDA only; it raises on the CPU) times each row the reference measures,
the five embed forwards and the four decode-top-k rows of each shape, at
the production shape on the card (``kernels/common.graph_time_ms``: the
device's time without the host's), into ``measured_us`` and
``bound_share`` = ``h100_us_bound / measured_us``; informational, never
checked.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \\
        --quick [--check] [--measure] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import numpy as np
import torch

from repro_torch.core import losses, quant
from repro_torch.core.bloom import BloomSpec, cached_hash_matrix
from repro_torch.kernels import bloom_ce as ce_lib
from repro_torch.kernels import bloom_csr as csr_lib
from repro_torch.kernels import bloom_decode as bd_lib
from repro_torch.kernels import bloom_decode_topk as dt_lib
from repro_torch.kernels import bloom_embed as be_lib
from repro_torch.kernels import common, ops, ref
from repro_torch.kernels.bloom_decode_topk import modeled_hbm_bytes
from repro_torch.launch.roofline import HBM_BW
from repro_torch.serving.control import plan_compaction

JSON_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "BENCH_kernels.json"
TOPK = 16
B_DECODE = 8
# serving-pool shape of the occupancy rows: 64 slots in row blocks of 8
B_POOL = 64
BT_POOL = 8
SPH_POOL = 16         # slots per host shard in the compaction row
MIN_OCC_RATIO = 1.5
MAX_COMPACT_VS_DENSE = 1.1
MIN_EMBED_CSR_RATIO = 3.0
MIN_DECODE_CSR_RATIO = 10.0
MIN_INT8_VS_FP32 = 3.0
MIN_INT8_VS_BF16 = 1.8
MIN_TOPK_RATIO = 3.0
ERR_SLACK = 1e-3
IS_F32 = torch.float32.itemsize
IS_I32 = torch.int32.itemsize
IS_TOPK_PAIR = IS_F32 + IS_I32     # a kept (value f32, id i32) pair
QUANT_EMBED_SWEEP = (("float32", "fp32"), ("bfloat16", "bf16"),
                     ("int8", "int8"), ("fp8_e4m3", "fp8"))
QUANT_TOPK_SWEEP = (("bfloat16", "bf16"), ("int8", "int8"),
                    ("fp8_e4m3", "fp8"))
# the reference's field swap, and the fields only --measure adds
TPU_FIELD, BOUND_FIELD = "tpu_us_model", "h100_us_bound"
MEASURED_FIELDS = ("measured_us", "bound_share")

# ---------------------------------------------------------------------------
# The reference's byte models of its TPU grids (src/repro/kernels/common.py
# and bloom_csr.py), copied: they model the TPU kernels' tiling, not the
# port's kernels (whose least traffic is each kernel module's min_bytes).
# ---------------------------------------------------------------------------

M_TILE = 512          # BWD_M_TILE: the TPU backward grids' m-tile
CSR_E_TILE = 128      # the TPU CSR grid's entry tile
SORT_PASSES = 4       # the modeled binning's passes over its (E,) keys


def csr_tile_counts(m: int, n_entries: int, m_tile: int = M_TILE,
                    e_tile: int = CSR_E_TILE):
    """(nM, NT, e_tile): the TPU CSR grid's m-tiles, entry tiles and
    entry-tile width."""
    m_tile = min(m_tile, m)
    e_tile = min(e_tile, max(n_entries, 1))
    nM = -(-m // m_tile)
    NT = n_entries // e_tile + nM
    return nM, NT, e_tile


def _bin_bytes(E: int, nM: int, NT: int, e_tile: int) -> int:
    """Modeled bytes of one TPU binning: the sort over (E,) keys and
    payloads, the tile layout's writes and the per-tile metadata."""
    sort = SORT_PASSES * 2 * E * 4
    layout = 2 * (NT * e_tile) * 4
    meta = 3 * NT * 4 + 3 * nM * 4
    return sort + layout + meta


def modeled_embed_bwd_csr_bytes(T: int, k: int, D: int, m: int,
                                m_tile: int = M_TILE,
                                e_tile: int = CSR_E_TILE,
                                d_tile: int = 512,
                                include_binning: bool = True) -> int:
    """Modeled HBM bytes of the TPU CSR embed backward: per d-block sweep
    the E = T*k live cotangent rows, the val tiles and the tile metadata,
    the (m, D) f32 output once, and (by default) the binning."""
    E = T * k
    nM, NT, e_tile = csr_tile_counts(m, E, m_tile, e_tile)
    d_tile = min(d_tile, D)
    nD = -(-D // d_tile)
    rows = E * d_tile * 4 * nD
    vals = nD * NT * e_tile * 4
    prefetch = (NT * e_tile + 3 * NT) * 4
    out = m * D * 4
    total = rows + vals + prefetch + out
    if include_binning:
        total += _bin_bytes(E, nM, NT, e_tile)
    return int(total)


def modeled_decode_bwd_csr_bytes(B: int, d: int, k: int, m: int,
                                 m_tile: int = M_TILE,
                                 e_tile: int = CSR_E_TILE) -> int:
    """Modeled HBM bytes of the TPU CSR decode backward: the cotangent
    transposed to (d, B) and back around the row scatter, one row per
    entry, the val tiles and metadata; the bins are cached per spec, so
    no binning."""
    E = d * k
    nM, NT, e_tile = csr_tile_counts(m, E, m_tile, e_tile)
    d_tile = min(512, B)
    nD = -(-B // d_tile)
    transpose_in = 2 * B * d * 4
    rows = nD * E * d_tile * 4
    vals = nD * NT * e_tile * 4
    prefetch = (NT * e_tile + 3 * NT) * 4
    out = m * B * 4 + 2 * B * m * 4
    return int(transpose_in + rows + vals + prefetch + out)


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def _cases():
    # (name, d, m, k, D, tokens)
    return [
        ("qwen3-4b", 151_936, 30_464, 4, 2560, 4096),
        ("qwen1.5-0.5b", 151_936, 30_464, 4, 1024, 4096),
        ("pixtral-12b", 131_072, 26_112, 4, 5120, 2048),
    ]


def _row(name, tokens, nbytes, err, bound_bytes, **extra):
    """A row: the reference's fields, with ``h100_us_bound`` from the
    port kernel's least bytes ``bound_bytes``."""
    return {"bench": "kernels", "name": name, "tokens": tokens,
            "bytes": nbytes, "max_err": err,
            BOUND_FIELD: 1e6 * bound_bytes / HBM_BW, **extra}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _grad(fn, x, cot):
    """d sum(fn(x) * cot) / dx by autograd."""
    return torch.autograd.grad((fn(x) * cot).sum(), x)[0]


def _measured(row, fn) -> None:
    """``measured_us`` (device time of one ``fn()``, CUDA graph replays)
    and ``bound_share`` into ``row``."""
    us = 1e3 * common.graph_time_ms(fn)
    row["measured_us"] = us
    row["bound_share"] = row[BOUND_FIELD] / us


def _log_softmax(gen, shape, dev):
    return torch.log_softmax(torch.randn(shape, generator=gen, device=dev),
                             -1)


def _embed_rows(gen, label, spec, D, T, Tc, tokens, measure):
    """embed.fwd (plain bf16 table and the four storages), embed.bwd and
    its two CSR rows.  ``tokens`` (T,) is the production draw; the checks
    read its first ``Tc``."""
    (d, m, k), dev = (spec.d, spec.m, spec.k), tokens.device
    table = torch.randn(m, D, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    tok = tokens[None, :Tc]
    idx = spec.indices_for(tok.reshape(-1))
    # the distinct rows the production draw gathers: the bounds' table read
    n_rows = int(spec.indices_for(tokens).unique().numel())
    its_tbl, its_idx, its_tok = (table.element_size(), idx.element_size(),
                                 tokens.element_size())
    rows = []

    # ---- embed fwd: k rows of D bf16 per token + the output write
    got = ops.bloom_embed(table, tok, spec)[0]
    bytes_fwd = T * (k * D * its_tbl + D * its_tbl) + T * k * its_idx
    row = _row(f"{label}.embed.fwd", T, bytes_fwd,
               _max_err(got, ref.bloom_embed_ref(table, idx)),
               be_lib.min_bytes(n_rows, T, k, D, its_tbl,
                                token_itemsize=its_tok),
               check_tokens=Tc)
    if measure:
        _measured(row, lambda: ops.bloom_embed(table, tokens[None], spec))
    rows.append(row)

    # ---- embed fwd on the stored tables, into f32.  The master table is
    # an inference tensor, which ops.bloom_embed quantizes on every call
    # (core.bloom.cached_quantized_table keeps no copy of it).  The oracle
    # gathers the rows quantized one by one, as core/quant.py quantizes the
    # whole table, and dequantized.
    with torch.inference_mode():
        master = table.float()
    gathered = idx.reshape(-1).long()
    sub_idx = torch.arange(gathered.numel(), device=dev).reshape(Tc, k)
    qbytes = {}
    for td, alias in QUANT_EMBED_SWEEP:
        its = quant.table_itemsize(td)
        out_is = its if td in ("float32", "bfloat16") else \
            torch.bfloat16.itemsize
        table_bytes = T * k * D * its
        if td == "int8":
            table_bytes += m * IS_F32 + 2 * T * k * IS_F32
        bytes_q = table_bytes + T * D * out_is + T * k * its_idx
        qbytes[alias] = (bytes_q, table_bytes)
        got = ops.bloom_embed(master, tok, spec, table_dtype=td,
                              out_dtype=torch.float32)[0]
        q_sub, s_sub = quant.quantize_table(master[gathered], td)
        want = ref.bloom_embed_ref(quant.dequantize_table(q_sub, s_sub),
                                   sub_idx)
        extra = {}
        if alias != "fp32":
            extra["vs_fp32_ratio"] = round(qbytes["fp32"][0] / bytes_q, 4)
        if alias == "int8":
            extra["vs_bf16_ratio"] = round(qbytes["bf16"][1] / table_bytes,
                                           4)
        row = _row(f"{label}.embed.fwd.{alias}", T, bytes_q,
                   _max_err(got, want),
                   be_lib.min_bytes(n_rows, T, k, D, its, IS_F32,
                                    row_scales=td == "int8",
                                    token_itemsize=its_tok),
                   check_tokens=Tc, table_dtype=td, table_bytes=table_bytes,
                   **extra)
        if measure:
            # the kernel on the table stored ahead, as the server reads it
            q, s = quant.quantize_table(master, td)
            _measured(row, lambda q=q, s=s: be_lib.
                      bloom_embed_tokens_fwd_quantized(q, s, tokens, spec,
                                                       torch.float32))
        rows.append(row)

    # ---- embed bwd, dense: the TPU grid sweeps m in M_TILE blocks and
    # re-reads g and idx each sweep; the f32 grad table is written once.
    # bytes_ideal is the single-pass scatter-add floor (g read, the grad
    # table's read-modify-write).  Checked at (16 tokens, D <= 512).
    n_mtiles = -(-m // M_TILE)
    Tb, Db = min(Tc, 16), min(D, 512)
    tbl32 = table[:, :Db].float().requires_grad_()
    cot = torch.randn(Tb, Db, generator=gen, device=dev)
    g_port = _grad(lambda t: ops.bloom_embed(t, tok[:, :Tb], spec,
                                             bwd_impl="dense")[0],
                   tbl32, cot)
    g_ref = _grad(lambda t: ref.bloom_embed_ref(t, idx[:Tb]), tbl32, cot)
    bytes_bwd = n_mtiles * (T * D * IS_F32 + T * k * its_idx) \
        + m * D * IS_F32
    bytes_bwd_ideal = T * D * IS_F32 + 2 * m * D * IS_F32 + T * k * its_idx
    rows.append(_row(
        f"{label}.embed.bwd", T, bytes_bwd, _max_err(g_port, g_ref),
        # the dense kernel's least traffic (bloom_embed.bloom_embed_bwd):
        # the f32 table out, the f32 cotangent and the indices in
        m * D * IS_F32 + T * D * IS_F32 + T * k * IS_I32,
        bytes_ideal=bytes_bwd_ideal,
        bwd_bytes_ratio=round(bytes_bwd / bytes_bwd_ideal, 4),
        check_tokens=Tb, check_dmodel=Db))

    # ---- embed bwd CSR (bwd_impl="csr"): the model is the same for any
    # draw.  Checked on a 4,096-row table: uniform tokens, then
    # collision-heavy ones, whose k rows all lie in the first M_TILE rows
    # (one m-tile of the TPU grid).
    bytes_bwd_csr = modeled_embed_bwd_csr_bytes(T, k, D, m)
    m_chk = 4096
    spec_c = BloomSpec(d=d, m=m_chk, k=k)
    tblc = torch.randn(m_chk, Db, generator=gen, device=dev
                       ).requires_grad_()
    heavy = torch.nonzero(cached_hash_matrix(spec_c, dev).amax(1)
                          < min(M_TILE, m_chk)).squeeze(1)
    for variant in ("", ".skew"):
        if variant:
            tok_c = heavy[torch.randint(0, heavy.numel(), (1, Tb),
                                        generator=gen, device=dev)]
        else:
            tok_c = torch.randint(0, d, (1, Tb), generator=gen, device=dev)
        cot_c = torch.randn(Tb, Db, generator=gen, device=dev)
        idx_c = spec_c.indices_for(tok_c.reshape(-1))
        g_port = _grad(lambda t: ops.bloom_embed(t, tok_c, spec_c,
                                                 bwd_impl="csr")[0],
                       tblc, cot_c)
        g_ref = _grad(lambda t: ref.bloom_embed_ref(t, idx_c), tblc, cot_c)
        rows.append(_row(
            f"{label}.embed.bwd.csr{variant}", T, bytes_bwd_csr,
            _max_err(g_port, g_ref),
            csr_lib.bin_min_bytes(T * k, m)
            + csr_lib.min_bytes(T * k, T, m, D, IS_F32),
            bytes_ideal=bytes_bwd_ideal,
            bwd_bytes_ratio=round(bytes_bwd_csr / bytes_bwd_ideal, 4),
            vs_dense_ratio=round(bytes_bwd / bytes_bwd_csr, 4),
            skew="collision_heavy" if variant else "uniform",
            check_tokens=Tb, check_m=m_chk, check_dmodel=Db))
    return rows


def _ce_rows(gen, label, spec, T, Tc, dev):
    """ce.fwd: one read of the (T, m) f32 logits; ce.bwd: the logits read
    and dz written once (its own floor)."""
    d, m, k = spec.d, spec.m, spec.k
    logits = torch.randn(Tc, m, generator=gen, device=dev)
    labels = torch.randint(0, d, (Tc,), generator=gen, device=dev)
    got = ops.bloom_ce(logits, labels, spec)
    want = losses.bloom_xent_label(spec, logits, labels)
    h = spec.indices_for(labels)
    bytes_fwd = T * m * IS_F32 + T * k * h.element_size() + 2 * T * IS_F32
    rows = [_row(f"{label}.ce.fwd", T, bytes_fwd, _max_err(got, want),
                 ce_lib.min_bytes(T, m, k), check_tokens=Tc)]
    cot = torch.randn(Tc, generator=gen, device=dev)
    z = logits.requires_grad_()
    g_port = _grad(lambda z: ops.bloom_ce(z, labels, spec), z, cot)
    g_ref = _grad(lambda z: ref.bloom_ce_ref(z, h), z, cot)
    bytes_bwd = 2 * T * m * IS_F32 + T * (k + 2) * IS_F32
    rows.append(_row(f"{label}.ce.bwd", T, bytes_bwd,
                     _max_err(g_port, g_ref),
                     ce_lib.min_bytes(T, m, k, backward=True),
                     bytes_ideal=bytes_bwd, bwd_bytes_ratio=1.0,
                     check_tokens=Tc))
    return rows


def _decode_rows(gen, label, spec, dev, measure):
    """decode, its dense and CSR backwards, decode_then_topk and the fused
    decode-top-k on every storage, at B = 8."""
    (d, m, k), B = (spec.d, spec.m, spec.k), B_DECODE
    n_mtiles = -(-m // M_TILE)
    rows = []

    # ---- decode fwd: the logp rows, the (d, k) hash matrix, the scores
    logp = _log_softmax(gen, (B, m), dev)
    scores = ops.bloom_decode(logp, spec)
    H = cached_hash_matrix(spec, dev)
    its_idx = H.element_size()
    want_scores = ref.bloom_decode_ref(logp, H)
    bytes_dec = B * m * IS_F32 + d * k * its_idx + B * d * IS_F32
    # the port's decode reads H as 16-bit words (bloom_decode.pack_h)
    dec_bound = bd_lib.min_bytes(B, m, d, k, index_bytes=torch.int16.itemsize)
    rows.append(_row(f"{label}.decode", B, bytes_dec,
                     _max_err(scores, want_scores), dec_bound))

    # ---- decode bwd, dense: the TPU grid re-reads g and H per m-tile.
    # Checked at a scaled vocab (d 4,096, m 1,024).
    d_chk, m_chk = 4096, 1024
    spec_chk = BloomSpec(d=d_chk, m=m_chk, k=k)
    H_chk = cached_hash_matrix(spec_chk, dev)
    logp_chk = _log_softmax(gen, (B, m_chk), dev).requires_grad_()
    cot = torch.randn(B, d_chk, generator=gen, device=dev)
    g_port = _grad(lambda lp: ops.bloom_decode(lp, spec_chk,
                                               bwd_impl="dense"),
                   logp_chk, cot)
    g_ref = _grad(lambda lp: ref.bloom_decode_ref(lp, H_chk), logp_chk, cot)
    bytes_bwd = n_mtiles * (B * d * IS_F32 + d * k * its_idx) \
        + B * m * IS_F32
    bytes_bwd_ideal = B * d * IS_F32 + d * k * its_idx + B * m * IS_F32
    rows.append(_row(
        f"{label}.decode.bwd", B, bytes_bwd, _max_err(g_port, g_ref),
        # the dense backward moves the f32 forward's bytes (min_bytes)
        bd_lib.min_bytes(B, m, d, k),
        bytes_ideal=bytes_bwd_ideal,
        bwd_bytes_ratio=round(bytes_bwd / bytes_bwd_ideal, 4),
        check_d=d_chk, check_m=m_chk))

    # ---- decode bwd CSR: the row scatter on the transposed cotangent;
    # the bins are per spec and cached, so neither the model nor the bound
    # counts the binning.  Checked on a random H (d 2,048, m 1,024),
    # uniform, then every index in the first M_TILE rows.
    bytes_bwd_csr = modeled_decode_bwd_csr_bytes(B, d, k, m)
    dc_chk, mc_chk = 2048, 1024
    spec_dc = BloomSpec(d=dc_chk, m=mc_chk, k=k)
    logp_c = _log_softmax(gen, (B, mc_chk), dev).requires_grad_()
    cot_c = torch.randn(B, dc_chk, generator=gen, device=dev)
    for variant, hi in (("", mc_chk), (".skew", min(M_TILE, mc_chk))):
        H_c = torch.randint(0, hi, (dc_chk, k), generator=gen, device=dev,
                            dtype=torch.int32)
        g_port = _grad(lambda lp: ops.bloom_decode(
            lp, spec_dc, hash_matrix=H_c, bwd_impl="csr"), logp_c, cot_c)
        g_ref = _grad(lambda lp: ref.bloom_decode_ref(lp, H_c), logp_c,
                      cot_c)
        rows.append(_row(
            f"{label}.decode.bwd.csr{variant}", B, bytes_bwd_csr,
            _max_err(g_port, g_ref),
            csr_lib.min_bytes(d * k, d, m, B, IS_F32),
            bytes_ideal=bytes_bwd_ideal,
            bwd_bytes_ratio=round(bytes_bwd_csr / bytes_bwd_ideal, 4),
            vs_dense_ratio=round(bytes_bwd / bytes_bwd_csr, 4),
            skew="collision_heavy" if variant else "uniform",
            check_d=dc_chk, check_m=mc_chk))

    # ---- decode then top-k: the (B, d) scores written and read back
    want_v = torch.topk(want_scores, TOPK).values
    bytes_then = B * m * IS_F32 + d * k * its_idx \
        + 2 * B * d * IS_F32 + B * TOPK * IS_TOPK_PAIR
    rows.append(_row(f"{label}.decode_then_topk", B, bytes_then,
                     _max_err(torch.topk(scores, TOPK).values, want_v),
                     dec_bound + B * d * IS_F32 + B * TOPK * IS_TOPK_PAIR,
                     topk=TOPK))

    # ---- fused decode-top-k: the scores never leave the kernel.  The
    # error also scores the returned ids through the oracle's scores.
    vals, ids = ops.bloom_decode_topk(logp, spec, TOPK)
    picked = want_scores.gather(-1, ids.long())
    bytes_fused = B * m * IS_F32 + d * k * its_idx + B * TOPK * IS_TOPK_PAIR
    row = _row(f"{label}.decode_topk", B, bytes_fused,
               max(_max_err(vals, want_v), _max_err(picked, want_v)),
               dt_lib.min_bytes(B, B, m=m, d=d, k=k, topk=TOPK),
               topk=TOPK, hbm_ratio=bytes_then / bytes_fused)
    if measure:
        _measured(row, lambda: ops.bloom_decode_topk(logp, spec, TOPK))
    rows.append(row)

    # ---- fused decode-top-k on narrow logp with the in-kernel hash (no H
    # stream); int8 adds a scale a row.  Checked against the oracle on the
    # dequantized logp, the returned ids scored through it too (an int8
    # tie may flip).
    for td, alias in QUANT_TOPK_SWEEP:
        its = quant.table_itemsize(td)
        q, s = quant.quantize_table(logp, td)
        want_q = ref.bloom_decode_ref(quant.dequantize_table(q, s), H)
        want_qv = torch.topk(want_q, TOPK).values
        vals_q, ids_q = ops.bloom_decode_topk(logp, spec, TOPK,
                                              table_dtype=td)
        picked = want_q.gather(-1, ids_q.long())
        bytes_q = modeled_hbm_bytes(
            np.ones(B, bool), B, m=m, d=d, k=k, topk=TOPK,
            logp_itemsize=its, inkernel_hash=True, row_scales=td == "int8")
        extra = {"vs_fp32_ratio": round(bytes_fused / bytes_q, 4)}
        if td == "int8":
            bytes_bf16 = modeled_hbm_bytes(
                np.ones(B, bool), B, m=m, d=d, k=k, topk=TOPK,
                logp_itemsize=quant.table_itemsize("bfloat16"),
                inkernel_hash=True)
            extra["vs_bf16_ratio"] = round(bytes_bf16 / bytes_q, 4)
        row = _row(f"{label}.decode_topk.{alias}", B, bytes_q,
                   max(_max_err(vals_q, want_qv),
                       _max_err(picked, want_qv)),
                   dt_lib.min_bytes(B, B, m=m, d=d, k=k, topk=TOPK,
                                    logp_itemsize=its, inkernel_hash=True,
                                    row_scales=td == "int8"),
                   topk=TOPK, table_dtype=td, inkernel_hash=True, **extra)
        if measure:
            # the kernel on the rows stored ahead
            _measured(row, lambda q=q, s=s: dt_lib.bloom_decode_topk(
                q, None, TOPK, scales=s, hash_spec=(d, k, spec.seed)))
        rows.append(row)
    return rows


def _topk_err(vals, ids, want_vals, want_ids) -> float:
    return max(_max_err(vals, want_vals),
               float((ids.long() - want_ids.long()).abs().max()))


def _pool_rows(gen, label, spec, dev):
    """The serving pool's row-skipping decode-top-k at 100, 50 and 12.5%
    occupancy, and a scattered pool compacted by the control plane's
    ``plan_compaction``.  The model streams a b_tile block of logp and H
    per visited block; checked at (d 4,096, m 512)."""
    d, m, k = spec.d, spec.m, spec.k
    nB = B_POOL // BT_POOL
    d_chk, m_chk = 4096, 512
    spec_occ = BloomSpec(d=d_chk, m=m_chk, k=k)
    logp = _log_softmax(gen, (B_POOL, m_chk), dev)
    dense_v, dense_i = ops.bloom_decode_topk(logp, spec_occ, TOPK)

    def model(active):
        return modeled_hbm_bytes(active, BT_POOL, m=m, d=d, k=k, topk=TOPK)

    def bound(n_live):
        return dt_lib.min_bytes(n_live, B_POOL, m=m, d=d, k=k, topk=TOPK)

    bytes_full = model(np.ones(B_POOL, bool))
    rows = []
    for occ_name, frac in (("occ100", 1.0), ("occ50", 0.5),
                           ("occ12", 0.125)):
        n_act = int(B_POOL * frac)
        active = np.arange(B_POOL) < n_act
        bytes_occ = model(active)
        # the port's kernel skips dead rows one by one (the TPU grid, a
        # block at a time: for these prefix masks the live rows agree)
        live = torch.as_tensor(active, device=dev)
        vals, ids = ops.bloom_decode_topk(logp, spec_occ, TOPK, active=live)
        err = _topk_err(vals[live], ids[live], dense_v[live], dense_i[live])
        if not live.all():
            dead_ok = bool((vals[~live] == -math.inf).all()
                           and (ids[~live] == 0).all())
            if not dead_ok:      # skipped rows must read (-inf, 0)
                err = math.inf
        rows.append(_row(
            f"{label}.decode_topk.{occ_name}", B_POOL, bytes_occ, err,
            bound(n_act), topk=TOPK, occupancy=frac, active_slots=n_act,
            visited_blocks=-(-n_act // BT_POOL), total_blocks=nB,
            hbm_ratio_vs_full=round(bytes_full / bytes_occ, 4),
            check_d=d_chk, check_m=m_chk))

    # ---- compaction: 4 host shards of SPH_POOL slots, the even slots
    # live, so every row block holds one; packing each host's live slots
    # into its prefix halves the visited blocks.  The permuted pool must
    # give each live slot the same top-k.
    scattered = np.zeros(B_POOL, bool)
    scattered[::2] = True
    occupant = [s if scattered[s] else -1 for s in range(B_POOL)]
    perm = np.asarray(plan_compaction(occupant, SPH_POOL, threshold=0.0))
    compacted = scattered[perm]
    b_sc, b_co = model(scattered), model(compacted)
    b_de = model(np.arange(B_POOL) < int(scattered.sum()))
    v_sc, i_sc = ops.bloom_decode_topk(
        logp, spec_occ, TOPK, active=torch.as_tensor(scattered, device=dev))
    perm_t = torch.as_tensor(perm, device=dev)
    v_co, i_co = ops.bloom_decode_topk(
        logp[perm_t], spec_occ, TOPK,
        active=torch.as_tensor(compacted, device=dev))
    live_new = torch.as_tensor(np.flatnonzero(compacted), device=dev)
    old = perm_t[live_new]
    rows.append(_row(
        f"{label}.decode_topk.scatter_compact", B_POOL, b_co,
        _topk_err(v_co[live_new], i_co[live_new], v_sc[old], i_sc[old]),
        bound(int(compacted.sum())), topk=TOPK, occupancy=0.5,
        active_slots=int(scattered.sum()), slots_per_host=SPH_POOL,
        bytes_scattered=b_sc, bytes_dense=b_de,
        hbm_ratio_vs_scattered=round(b_sc / b_co, 4),
        vs_dense_ratio=round(b_co / b_de, 4),
        check_d=d_chk, check_m=m_chk))
    return rows


def run(device=None, quick: bool = True, measure: bool = False) -> list:
    """The 69 rows on ``device`` (CUDA unless ``device="cpu"``): the
    kernels on the card, their plain twins on the CPU.  ``quick`` checks
    at most 64 tokens (the committed rows' check shapes), else 256.
    ``measure`` (CUDA only) times the rows the reference times."""
    dev = common.resolve_device(device)
    if measure and dev.type != "cuda":
        raise ValueError("--measure times the kernels on the card: it needs "
                         "--device cuda")
    rows = []
    for label, d, m, k, D, T in _cases():
        gen = torch.Generator(device=dev).manual_seed(0)
        spec = BloomSpec(d=d, m=m, k=k)
        Tc = min(T, 64 if quick else 256)
        tokens = torch.randint(0, d, (T,), generator=gen, device=dev)
        rows += _embed_rows(gen, label, spec, D, T, Tc, tokens, measure)
        rows += _ce_rows(gen, label, spec, T, Tc, dev)
        rows += _decode_rows(gen, label, spec, dev, measure)
        rows += _pool_rows(gen, label, spec, dev)
    return rows


def check_against(rows, path=JSON_PATH, err_slack=ERR_SLACK,
                  min_topk_ratio=MIN_TOPK_RATIO) -> list[str]:
    """The fresh rows against the committed JSON (read only): the
    reference's gates, and every row's fields and their values but
    ``max_err`` equal to the committed row's, ``tpu_us_model`` swapped for
    ``h100_us_bound`` (``--measure``'s fields allowed).  Returns the
    failures."""
    committed = {r["name"]: r for r in
                 json.loads(path.read_text())["rows"]}
    failures = []
    fresh_names = {r["name"] for r in rows}
    for gone in sorted(set(committed) - fresh_names):
        failures.append(f"{gone}: bench row disappeared from the fresh run "
                        "— a kernel bench was dropped or renamed")
    for r in rows:
        name = r["name"]
        old = committed.get(name)
        if old is None:
            failures.append(f"{name}: missing from {path.name}")
            continue
        if not r["max_err"] <= old["max_err"] + err_slack:
            failures.append(f"{name}: max_err regressed "
                            f"{old['max_err']:.2e} -> {r['max_err']:.2e}")
        if r["bytes"] != old["bytes"]:
            failures.append(f"{name}: bytes model changed "
                            f"{old['bytes']} -> {r['bytes']}")
        want = set(old) - {TPU_FIELD} | {BOUND_FIELD}
        have = set(r) - set(MEASURED_FIELDS)
        if have != want:
            failures.append(f"{name}: fields differ from the committed row's "
                            f"(missing {sorted(want - have)}, extra "
                            f"{sorted(have - want)})")
        for f in sorted(set(old) & set(r) - {TPU_FIELD, "max_err", "bytes"}):
            if r[f] != old[f]:
                failures.append(f"{name}.{f}: committed {old[f]!r}, fresh "
                                f"{r[f]!r}")
        if name.endswith(".decode_topk") \
                and r.get("hbm_ratio", 0.0) < min_topk_ratio:
            failures.append(
                f"{name}: fused top-k HBM ratio {r.get('hbm_ratio', 0.0):.2f}"
                f" < {min_topk_ratio} — serving fusion no longer pays")
        if name.endswith(".embed.fwd.int8") \
                or name.endswith(".decode_topk.int8"):
            if r.get("vs_fp32_ratio", 0.0) < MIN_INT8_VS_FP32:
                failures.append(
                    f"{name}: int8/fp32 bytes ratio "
                    f"{r.get('vs_fp32_ratio', 0.0):.2f} < {MIN_INT8_VS_FP32}"
                    " — int8 storage no longer closes the table-stream gap")
            if r.get("vs_bf16_ratio", 0.0) < MIN_INT8_VS_BF16:
                failures.append(
                    f"{name}: int8/bf16 bytes ratio "
                    f"{r.get('vs_bf16_ratio', 0.0):.2f} < {MIN_INT8_VS_BF16}"
                    " — int8 no longer beats plain bf16 storage "
                    "meaningfully")
        if ".embed.bwd.csr" in name \
                and r.get("vs_dense_ratio", 0.0) < MIN_EMBED_CSR_RATIO:
            failures.append(
                f"{name}: CSR/dense bytes ratio "
                f"{r.get('vs_dense_ratio', 0.0):.2f} < {MIN_EMBED_CSR_RATIO}"
                " — the binned embed backward no longer closes the backward "
                "bytes gap")
        if ".decode.bwd.csr" in name \
                and r.get("vs_dense_ratio", 0.0) < MIN_DECODE_CSR_RATIO:
            failures.append(
                f"{name}: CSR/dense bytes ratio "
                f"{r.get('vs_dense_ratio', 0.0):.2f} < "
                f"{MIN_DECODE_CSR_RATIO} — the binned decode backward no "
                "longer closes the backward bytes gap")
        if (".decode_topk.occ" in name and not name.endswith(".occ100")
                and r.get("occupancy", 1.0) <= 0.5
                and r.get("hbm_ratio_vs_full", 0.0) < MIN_OCC_RATIO):
            failures.append(
                f"{name}: occupancy bytes ratio "
                f"{r.get('hbm_ratio_vs_full', 0.0):.2f} < {MIN_OCC_RATIO} "
                "— row skipping no longer pays at partial occupancy")
        if name.endswith(".decode_topk.scatter_compact"):
            if r.get("hbm_ratio_vs_scattered", 0.0) < MIN_OCC_RATIO:
                failures.append(
                    f"{name}: compaction bytes recovery "
                    f"{r.get('hbm_ratio_vs_scattered', 0.0):.2f} < "
                    f"{MIN_OCC_RATIO} — densifying scattered slots no "
                    "longer pays")
            if r.get("vs_dense_ratio", math.inf) > MAX_COMPACT_VS_DENSE:
                failures.append(
                    f"{name}: compacted bytes are "
                    f"{r.get('vs_dense_ratio', math.inf):.2f}x the "
                    f"dense-occupancy model (> {MAX_COMPACT_VS_DENSE}) — "
                    "per-host packing is leaving b_tile tails behind")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="check at most 64 tokens (the committed rows' "
                         "check shapes)")
    ap.add_argument("--check", action="store_true",
                    help=f"hold the rows against {JSON_PATH.name} (read "
                         "only); needs --quick")
    ap.add_argument("--measure", action="store_true",
                    help="time the embed forward and decode-top-k rows on "
                         "the card at the production shape (never checked)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.check and not args.quick:
        ap.error("--check requires --quick (the committed rows are "
                 "--quick's)")
    device = common.resolve_device(args.device)
    if device.type == "cuda":
        common.build()     # nvcc at first use, ahead of the rows
    rows = run(device, quick=args.quick, measure=args.measure)
    for row in rows:
        print(row)
    if args.check:
        failures = check_against(rows)
        for f in failures:
            print("REGRESSION:", f, file=sys.stderr)
        if failures:
            sys.exit(1)
        print(f"check ok: {len(rows)} rows on {device} vs {JSON_PATH.name}")


if __name__ == "__main__":
    main()
