"""Plain PyTorch oracles for the kernels."""
from __future__ import annotations

import torch


def bloom_embed_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (m, D); idx (T, k) hash indices -> (T, D) k-way gather-sum."""
    rows = table[idx.long()]                       # (T, k, D)
    return rows.sum(dim=1)


def bloom_decode_ref(logp: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """logp (B, m); H (d, k) -> scores (B, d) with
    scores[b, i] = sum_j logp[b, H[i, j]], summed in j order."""
    h = H.long()
    scores = logp[:, h[:, 0]]
    for j in range(1, H.shape[1]):
        scores = scores + logp[:, h[:, j]]
    return scores
