"""Model-shaped wrappers around the kernels.

These adapt model-layer shapes ((..., m) activations, BloomSpec hash
generation) to the flat kernel interfaces.  Each kernel entry picks its
hand-written CUDA kernel for CUDA tensors and its plain PyTorch version for
CPU tensors, so the same call sites run everywhere.  ``bloom_embed``,
``bloom_ce`` and ``bloom_decode`` are differentiable: their backwards are
kernels too (the Bloom CE backward, and for the embedding and the decode
the CSR scatter-add or, with ``bwd_impl="dense"``, the dense m-tile
sweep).  ``bloom_decode`` is the full Eq. 3 recovery, (..., d) scores for
ranking losses and gradient sweeps; ``bloom_decode_topk`` is the serving
path that never materializes them.

Vocab-sized hash matrices come from ``core.bloom.cached_hash_matrix`` — one
(d, k) device tensor per (BloomSpec, device), shared across decode calls so
the serving loop never rehashes the vocabulary per step.  With a
``table_dtype`` (core/quant.py) the decode drops that matrix for an
on-the-fly spec and hashes in the kernel, and a frozen embedding table is
quantized once (``core.bloom.cached_quantized_table``).  The CSR bins of
that matrix, which the decode's ``bwd_impl="csr"`` backward reads, are
built once per (spec, device) too (``core.bloom.cached_decode_bins``), and
only when the decode is differentiated; so is the 16-bit copy of the
matrix that the Eq. 3 decode kernel reads
(``core.bloom.cached_packed_hash_matrix``).

The vocab-parallel pair of a tensor-parallel step: ``bloom_embed`` with
``lo`` (one rank's rows of the table) and ``bloom_ce_sharded`` (one
rank's columns of the logits), over the kernels' row ranges; the caller
passes the collectives that combine the ranks (this layer imports none).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.bloom import (BloomSpec, cached_decode_bins,
                                    cached_hash_matrix,
                                    cached_packed_hash_matrix,
                                    cached_quantized_table)
from repro_torch.kernels import bloom_ce as ce_lib
from repro_torch.kernels import common
from repro_torch.kernels.bloom_ce import bloom_ce as _ce
from repro_torch.kernels.bloom_decode import bloom_decode as _decode
from repro_torch.kernels.bloom_decode_topk import \
    bloom_decode_topk as _decode_topk
from repro_torch.kernels.bloom_embed import bloom_embed as _embed
from repro_torch.kernels.bloom_embed import bloom_embed_tokens_fwd_quantized


def bloom_embed(table: torch.Tensor, tokens: torch.Tensor,
                spec: BloomSpec, bwd_impl: str = "csr",
                table_dtype: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None,
                lo: Optional[int] = None) -> torch.Tensor:
    """table (m, D); tokens (B, S) -> (B, S, D): each token's k hashed
    table rows summed (Eq. 1's k-hot code times the table).  On CUDA
    tensors one launch of the embed kernel's token entry, which hashes the
    tokens itself (``kernels.bloom_embed``); on the CPU
    ``spec.indices_for`` and the plain gather-sum.
    Differentiable in ``table``: the backward is the CSR scatter-add
    (``bwd_impl="csr"``) or the dense m-tile sweep (``"dense"``), as
    ``ModelConfig.bwd_impl`` says through models/io.py.

    ``table_dtype`` stores the table narrow for the gather.  When a
    gradient is wanted (grad mode on and ``table`` requiring it) the table
    is quantized in the graph and the gradient is straight-through into
    ``table``; otherwise (serving) the quantized table comes from
    ``core.bloom.cached_quantized_table`` and the forward-only kernel runs
    on it, with ``out_dtype`` defaulting to float32 there, as in the
    reference.

    ``lo``: ``table`` holds the rows [lo, lo + rows) of the spec's m
    (one rank's shard, read as it is or, with ``table_dtype``, quantized
    row by row as the whole table would be): the output is this shard's
    part of the sum (the embed kernel's row range,
    ``bloom_embed.hash.range``, ``bloom_embed.int8.hash.range`` and their
    kin), its gradient the shard's rows.  Forward-only, the shard's
    quantized copy comes from ``cached_quantized_table`` like a whole
    table's: its key (spec, table_dtype, device) is one entry per rank
    process, each rank holding its own shard."""
    B, S = tokens.shape
    flat = tokens.reshape(-1).contiguous()
    td = quant.resolve_table_dtype(table_dtype)
    if td is not None and not (torch.is_grad_enabled()
                               and table.requires_grad):
        qtable, scales = cached_quantized_table(spec, table, td)
        out = bloom_embed_tokens_fwd_quantized(
            qtable, scales, flat, spec,
            torch.float32 if out_dtype is None else out_dtype, lo)
    else:
        out = _embed(table, flat, table_dtype=td, out_dtype=out_dtype,
                     bwd_impl=bwd_impl, spec=spec, lo=lo)
    return out.reshape(B, S, -1)


def bloom_ce(logits: torch.Tensor, labels: torch.Tensor,
             spec: BloomSpec) -> torch.Tensor:
    """logits (..., m) f32; labels (...,) -> per-position loss (...,) f32,
    differentiable in ``logits``.  Negative labels (masked positions) are
    clamped to 0, as the reference does; the caller masks their loss."""
    shape = labels.shape
    z = logits.reshape(-1, logits.shape[-1]).contiguous()
    h = spec.indices_for(labels.reshape(-1).clamp_min(0)).contiguous()
    return _ce(z, h).reshape(shape)


class _VocabParallelCE(torch.autograd.Function):
    """The loss (T,) of one rank's columns z (T, m_local) of the logits;
    the backward's dz is exact on the shard."""

    @staticmethod
    def forward(ctx, z, h, lo, gather, reduce):
        if common.resolve_impl(z, h) == "kernel":
            lse_local, hits = ce_lib.bloom_ce_shard_cuda(z, h, lo)
        else:
            lse_local, hits = common.run_plain(
                ce_lib.FWD_RANGE,
                lambda: ce_lib.min_bytes(*z.shape, h.shape[1]),
                ce_lib.bloom_ce_shard_plain, z, h, lo)
        lse = torch.logsumexp(torch.stack(gather(lse_local)), dim=0)
        ctx.save_for_backward(z, h, lse)
        ctx.lo = lo
        return lse - reduce(hits) / h.shape[1]

    @staticmethod
    def backward(ctx, g):
        z, h, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if common.resolve_impl(z, h) == "kernel":
            dz = ce_lib.bloom_ce_bwd_cuda(g, z, h, lse, ctx.lo)
        else:
            dz = common.run_plain(
                ce_lib.BWD_RANGE,
                lambda: ce_lib.min_bytes(*z.shape, h.shape[1], True),
                ce_lib.bloom_ce_bwd_plain, g, z, h, lse, ctx.lo)
        return dz.to(z.dtype), None, None, None, None


def bloom_ce_sharded(logits: torch.Tensor, labels: torch.Tensor,
                     spec: Optional[BloomSpec], lo: int, gather,
                     reduce) -> torch.Tensor:
    """The vocab-parallel Bloom CE: logits (..., m_local) f32, this rank's
    columns [lo, lo + m_local) of the m-dim logits; labels (...,) ->
    per-position loss (...,) f32, the same on every rank, differentiable
    in ``logits``.  ``gather(t)`` returns every rank's ``t`` along the
    model axis, ``reduce(t)`` their sum.  Each rank runs the ranged CE
    forward (its local lse and the sum of its picked logits); the global
    lse is the logsumexp of the gathered local ones, the hit sum is
    reduced, and loss = lse - hits / k; the ranged backward takes the
    global lse.  ``spec`` None (a dense vocab) is the CE of k = 1 on the
    label itself."""
    shape = labels.shape
    z = logits.reshape(-1, logits.shape[-1]).contiguous()
    flat = labels.reshape(-1).clamp_min(0)
    h = (flat[:, None].to(torch.int32) if spec is None
         else spec.indices_for(flat)).contiguous()
    return _VocabParallelCE.apply(z, h, lo, gather, reduce).reshape(shape)


def bloom_decode(logp: torch.Tensor, spec: BloomSpec,
                 hash_matrix: Optional[torch.Tensor] = None,
                 bwd_impl: str = "csr",
                 table_dtype: Optional[str] = None) -> torch.Tensor:
    """logp (..., m) -> Eq. 3 scores (..., d) f32 over the original vocab,
    differentiable in ``logp``.

    With the spec-cached hash matrix and ``bwd_impl="csr"`` the backward
    reads the spec's cached CSR bins (``core.bloom.cached_decode_bins``,
    built at the first backward, never by a forward-only caller); a
    caller-supplied ``hash_matrix`` is binned inside the backward.
    ``bwd_impl="dense"`` bins H on the card on every call instead.
    ``table_dtype`` quantizes the logp rows per call for the kernel to
    read narrow; the gradient is straight-through."""
    lead = logp.shape[:-1]
    flat = logp.reshape(-1, logp.shape[-1]).contiguous()
    bins_fn = packed = None
    if hash_matrix is None:
        H = cached_hash_matrix(spec, logp.device)
        if logp.is_cuda:
            packed = cached_packed_hash_matrix(spec, logp.device)
        if bwd_impl == "csr":
            bins_fn = functools.partial(cached_decode_bins, spec,
                                        logp.device)
    else:
        H = hash_matrix.to(torch.int32).contiguous()
    scores = _decode(flat, H, bwd_impl=bwd_impl,
                     table_dtype=quant.resolve_table_dtype(table_dtype),
                     bins_fn=bins_fn, packed=packed)
    return scores.reshape(*lead, spec.d)


def bloom_decode_topk(logp: torch.Tensor, spec: BloomSpec, topk: int,
                      active: torch.Tensor | None = None,
                      table_dtype: Optional[str] = None):
    """logp (..., m) f32 -> fused Eq. 3 + top-k: (values, ids), each
    (..., topk).

    Never materializes the (..., d) recovered-score matrix.  ``active``
    (...,) bool skips dead rows, which return (-inf, 0).

    ``table_dtype`` quantizes the logp rows per call (torch ops; int8 with
    one scale per row) for the kernel to read narrow, and, for an
    on-the-fly spec that is not the identity, drops the (d, k) hash matrix:
    the kernel re-derives each id's indices, bit-identical to the cached
    matrix.  Otherwise the cached matrix is read.
    """
    lead = logp.shape[:-1]
    flat = logp.reshape(-1, logp.shape[-1]).float().contiguous()
    act = None if active is None else active.reshape(-1)
    td = quant.resolve_table_dtype(table_dtype)
    scales = None
    if td is not None:
        flat, scales = quant.quantize_table(flat, td)
    inkernel = (td is not None and spec.on_the_fly
                and not (spec.m == spec.d and spec.k == 1))
    if inkernel:
        vals, ids = _decode_topk(flat, None, topk, active=act, scales=scales,
                                 hash_spec=(spec.d, spec.k, spec.seed))
    else:
        vals, ids = _decode_topk(flat, cached_hash_matrix(spec, logp.device),
                                 topk, active=act, scales=scales)
    return vals.reshape(*lead, topk), ids.reshape(*lead, topk)
