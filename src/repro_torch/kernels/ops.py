"""Model-shaped wrappers around the kernels.

These adapt model-layer shapes ((..., m) activations, BloomSpec hash
generation) to the flat kernel interfaces.  Each kernel entry picks its
hand-written CUDA kernel for CUDA tensors and its plain PyTorch version for
CPU tensors, so the same call sites run everywhere.

Vocab-sized hash matrices come from ``core.bloom.cached_hash_matrix`` — one
(d, k) device tensor per (BloomSpec, device), shared across decode calls so
the serving loop never rehashes the vocabulary per step.
"""
from __future__ import annotations

import torch

from repro_torch.core.bloom import BloomSpec, cached_hash_matrix
from repro_torch.kernels.bloom_decode_topk import \
    bloom_decode_topk as _decode_topk
from repro_torch.kernels.bloom_embed import bloom_embed as _embed


def bloom_embed(table: torch.Tensor, tokens: torch.Tensor,
                spec: BloomSpec) -> torch.Tensor:
    """table (m, D); tokens (B, S) -> (B, S, D): each token's k hashed
    table rows summed (Eq. 1's k-hot code times the table).

    Forward only on CUDA: with grad enabled and a table that requires
    grad the kernel raises (its backward is ROADMAP B4/B6); the CPU plain
    version is differentiable through autograd.
    """
    B, S = tokens.shape
    idx = spec.indices_for(tokens.reshape(-1)).contiguous()   # (T, k)
    return _embed(table, idx).reshape(B, S, -1)


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
