"""Cross-entropy losses for Bloom-embedded and dense-vocab outputs.

For an LM position (one target item) the Bloom target is exactly k-hot with
mass 1/k per projection, so

    CE = logsumexp(z) - (1/k) * sum_j z[H_j(y)]

which needs only a k-gather, never a dense m-hot target.  That identity is
what the fused CUDA kernel (``kernels/bloom_ce.py``) computes; the
functions here are the plain PyTorch oracles and the dense-vocab LM loss.
Copied from the JAX package's ``core/losses.py`` (the LM parts).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bloom import BloomSpec


def gather_last_axis(logits: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """logits (..., m), idx (..., k) -> (..., k) in float32; an index
    outside [0, m) (the -1 padding label) gives 0, as the reference's
    masked-sum gather does."""
    m = logits.shape[-1]
    ok = (idx >= 0) & (idx < m)
    picked = logits.float().gather(-1, torch.where(ok, idx, 0).long())
    return torch.where(ok, picked, 0.0)


def _logsumexp_f32(logits: torch.Tensor) -> torch.Tensor:
    z = logits.float()
    zmax = z.max(dim=-1, keepdim=True).values.detach()
    return torch.log(torch.exp(z - zmax).sum(dim=-1)) + zmax[..., 0]


def softmax_xent_label(logits: torch.Tensor, label: torch.Tensor,
                       valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Standard CE with integer labels (...,) over logits (..., n)."""
    logz = _logsumexp_f32(logits)
    picked = gather_last_axis(logits, label[..., None])
    loss = logz - picked[..., 0]
    if valid is not None:
        loss = loss * valid.to(loss.dtype)
    return loss


def bloom_xent_label(spec: BloomSpec, logits: torch.Tensor,
                     label: torch.Tensor,
                     hash_matrix: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bloom CE for single-item targets (the LM / next-click case).

    logits (..., m); label (...,) item ids in [0, d), negative ones masked
    by the caller (clamped to 0 here):
    loss = logsumexp(z) - (1/k) * sum_j z[H_j(label)], the k-gather done as
    one weighted pass over the m axis with w[i] = #{j : H_j(y) == i}.
    """
    idx = spec.indices_for(label.clamp_min(0), hash_matrix)   # (..., k)
    m = logits.shape[-1]
    iota = torch.arange(m, device=logits.device)
    w = torch.zeros(logits.shape, dtype=torch.int8, device=logits.device)
    for j in range(spec.k):
        w = w + (iota == idx[..., j:j + 1]).to(torch.int8)
    picked_sum = (logits.float() * w.float()).sum(dim=-1)
    loss = _logsumexp_f32(logits) - picked_sum / spec.k
    if valid is not None:
        loss = loss * valid.to(loss.dtype)
    return loss
