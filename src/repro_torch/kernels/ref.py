"""Plain PyTorch oracles for the kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import onehot_count


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


def bloom_decode_scaled_ref(q: torch.Tensor, scales: torch.Tensor,
                            H: torch.Tensor) -> torch.Tensor:
    """The int8 decode: the raw stored values summed in j order as f32,
    times each row's scale once, (sum_j q[b, H[i, j]]) * scales[b]."""
    return bloom_decode_ref(q.float(), H) * scales[:, None]


def bloom_decode_bwd_ref(g: torch.Tensor, H: torch.Tensor,
                         m: int) -> torch.Tensor:
    """g (B, d); H (d, k) -> dlogp (B, m) f32 = g @ onehot_count(H), the
    TPU kernel's one-hot contraction (-1 pads never match)."""
    return g.float() @ onehot_count(H, m)


def bloom_embed_bwd_ref(g: torch.Tensor, idx: torch.Tensor,
                        m: int) -> torch.Tensor:
    """g (T, D); idx (T, k) -> dtable (m, D) f32 = onehot_count(idx)^T @ g
    (-1 pads never match)."""
    return onehot_count(idx, m).t() @ g.float()


def bloom_ce_ref(logits: torch.Tensor, h_idx: torch.Tensor) -> torch.Tensor:
    """logits (T, m); h_idx (T, k) hashed labels ->
    loss (T,) = logsumexp(z) - mean_j z[h_j]."""
    z = logits.float()
    lse = torch.logsumexp(z, dim=-1)
    picked = z.gather(-1, h_idx.long())            # (T, k)
    return lse - picked.mean(-1)


def csr_scatter_add_ref(g: torch.Tensor, idx: torch.Tensor,
                        m: int) -> torch.Tensor:
    """g (T, D); idx (T, k) in [0, m) -> (m, D) f32 with
    out[r] = sum over (t, j) with idx[t, j] == r of g[t]."""
    T, k = idx.shape
    rows = torch.arange(T, device=g.device).repeat_interleave(k)
    out = torch.zeros(m, g.shape[1], dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx.reshape(-1).long(), g.float()[rows])
