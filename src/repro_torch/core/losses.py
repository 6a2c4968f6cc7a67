"""Cross-entropy losses for Bloom-embedded and dense-vocab outputs.

For an LM position (one target item) the Bloom target is exactly k-hot with
mass 1/k per projection, so

    CE = logsumexp(z) - (1/k) * sum_j z[H_j(y)]

which needs only a k-gather, never a dense m-hot target.  That identity is
what the fused CUDA kernel (``kernels/bloom_ce.py``) computes; the
functions here are the plain PyTorch oracles and the dense-vocab LM loss.
For item sets (the recommender's outputs) ``bloom_xent_multilabel`` takes
the CE against the normalized Bloom encoding of the set; the PMI and CCA
baselines train with ``cosine_proximity_loss``.  Copied from the JAX
package's ``core/losses.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bloom import BloomSpec, encode


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


def softmax_xent_dense(logits: torch.Tensor, target: torch.Tensor,
                       dim: int = -1) -> torch.Tensor:
    """CE against a dense target distribution (a row summing to 0 gives
    0, masked)."""
    logz = torch.logsumexp(logits, dim=dim)
    tmass = target.sum(dim=dim)
    return logz * tmass - (target * logits).sum(dim=dim)


def bloom_xent_multilabel(spec: BloomSpec, logits: torch.Tensor,
                          targets: torch.Tensor,
                          hash_matrix: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Bloom CE for item *sets* (recommender outputs).

    targets: (..., c_max) padded item ids (-1 = pad, encoding to nothing).
    The target distribution is the Bloom encoding u of the set (binary, as
    Eq. 1), normalized to sum 1; the mass is clipped at 1e-9, so an
    all-pad row has target 0 and loss 0.
    """
    u = encode(spec, targets, hash_matrix)                 # (..., m) binary
    mass = torch.clamp(u.sum(-1, keepdim=True), min=1e-9)
    return softmax_xent_dense(logits, u / mass)


def cosine_proximity_loss(pred: torch.Tensor, target: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Cosine loss used by the PMI / CCA alternatives (Chollet 2016)."""
    p = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + eps)
    t = target / (torch.linalg.vector_norm(target, dim=-1, keepdim=True)
                  + eps)
    return 1.0 - (p * t).sum(-1)
