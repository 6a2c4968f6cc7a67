"""Model-shaped wrappers around the kernels.

These adapt model-layer shapes ((..., m) activations, BloomSpec hash
generation) to the flat kernel interfaces.  Each kernel entry picks its
hand-written CUDA kernel for CUDA tensors and its plain PyTorch version for
CPU tensors, so the same call sites run everywhere.  ``bloom_embed`` and
``bloom_ce`` are differentiable: their backwards are kernels too (the CSR
scatter-add and the Bloom CE backward).

Vocab-sized hash matrices come from ``core.bloom.cached_hash_matrix`` — one
(d, k) device tensor per (BloomSpec, device), shared across decode calls so
the serving loop never rehashes the vocabulary per step.
"""
from __future__ import annotations

import torch

from repro_torch.core.bloom import BloomSpec, cached_hash_matrix
from repro_torch.kernels.bloom_ce import bloom_ce as _ce
from repro_torch.kernels.bloom_decode_topk import \
    bloom_decode_topk as _decode_topk
from repro_torch.kernels.bloom_embed import bloom_embed as _embed


def bloom_embed(table: torch.Tensor, tokens: torch.Tensor,
                spec: BloomSpec) -> torch.Tensor:
    """table (m, D); tokens (B, S) -> (B, S, D): each token's k hashed
    table rows summed (Eq. 1's k-hot code times the table).
    Differentiable in ``table``: the backward is the CSR scatter-add."""
    B, S = tokens.shape
    idx = spec.indices_for(tokens.reshape(-1)).contiguous()   # (T, k)
    return _embed(table, idx).reshape(B, S, -1)


def bloom_ce(logits: torch.Tensor, labels: torch.Tensor,
             spec: BloomSpec) -> torch.Tensor:
    """logits (..., m) f32; labels (...,) -> per-position loss (...,) f32,
    differentiable in ``logits``.  Negative labels (masked positions) are
    clamped to 0, as the reference does; the caller masks their loss."""
    shape = labels.shape
    z = logits.reshape(-1, logits.shape[-1]).contiguous()
    h = spec.indices_for(labels.reshape(-1).clamp_min(0)).contiguous()
    return _ce(z, h).reshape(shape)


def bloom_decode_topk(logp: torch.Tensor, spec: BloomSpec, topk: int,
                      active: torch.Tensor | None = None):
    """logp (..., m) f32 -> fused Eq. 3 + top-k: (values, ids), each
    (..., topk).

    Never materializes the (..., d) recovered-score matrix.  ``active``
    (...,) bool skips dead rows, which return (-inf, 0).
    """
    lead = logp.shape[:-1]
    flat = logp.reshape(-1, logp.shape[-1]).float().contiguous()
    act = None if active is None else active.reshape(-1)
    vals, ids = _decode_topk(flat, cached_hash_matrix(spec, logp.device),
                             topk, active=act)
    return vals.reshape(*lead, topk), ids.reshape(*lead, topk)
