"""Self-attention of the dense decoder: q/k/v/o projections with the
optional QKV bias, causal prefill that also emits the KV cache, and the
single-token slot decode against that cache.

The JAX package's ``models/attention.py`` computes attention in XLA,
outside any Pallas kernel, so the port computes it in plain PyTorch
(matmuls and an f32 softmax).  Weights keep the reference's layout:
``wq`` (D, H, hd), ``wk`` / ``wv`` (D, KV, hd), ``wo`` (H, hd, D), biases
(H, hd) / (KV, hd).  The reference's flash-style chunking, its cross
attention and its sharded-cache decode are not ported: they serve memory
limits of long sequences and models this path does not run.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class Attention(nn.Module):
    """The projection weights of one attention layer (reference layout)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.num_heads, cfg.num_kv_heads

        def w(d_in, d_out, shape):
            return nn.Parameter(layers.truncated_normal(
                (d_in, d_out), 1.0, generator).reshape(shape))

        self.wq = w(D, H * hd, (D, H, hd))
        self.wk = w(D, KV * hd, (D, KV, hd))
        self.wv = w(D, KV * hd, (D, KV, hd))
        self.wo = w(H * hd, D, (H, hd, D))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(H, hd))
            self.bk = nn.Parameter(torch.zeros(KV, hd))
            self.bv = nn.Parameter(torch.zeros(KV, hd))
        if cfg.qk_norm:
            raise NotImplementedError(
                "qk_norm (qwen3-style) is not ported yet (ROADMAP A12)")


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k and v (B, S, KV, hd), RoPE'd."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, KV, hd), valid (B, S, T) bool ->
    (B, S, H, hd).  Scores and softmax in f32, probabilities cast to q's
    dtype for the value product; KV heads repeat to H (GQA)."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    if H != KV:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, ., hd)
    s = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(hd)
    s = s.masked_fill(~valid[:, None], -math.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(w, vh).transpose(1, 2)


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(o.dtype))


def self_attention_with_cache(p: Attention, cfg: ModelConfig,
                              x: torch.Tensor, positions: torch.Tensor
                              ) -> tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """Prefill: causal self-attention over x (B, S, D) at ``positions``
    (B, S), which also returns the layer's compact KV cache
    {"k", "v"} (B, S, KV, hd) in x's dtype."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    causal = positions[:, :, None] >= positions[:, None, :]
    return _out(p, _attend(q, k, v, causal)), {"k": k, "v": v}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor], pos: torch.Tensor
                          ) -> torch.Tensor:
    """Single-token decode of x (B, 1, D) against ``cache`` {"k","v"}
    (B, T, KV, hd), where ``pos`` (B,) int is each row's own sequence
    offset (a continuous-batching slot pool).  Each row's new k/v is
    written at its ``pos`` IN PLACE (the reference returns a new cache;
    updating the pool saves a copy of it per layer per step), and keys at
    positions <= pos are attended.  Returns (B, 1, D)."""
    B, T = x.shape[0], cache["k"].shape[1]
    posb = pos.reshape(B, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, posb)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
    valid = torch.arange(T, device=x.device)[None, None, :] <= posb[:, :, None]
    o = _attend(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), valid)
    return _out(p, o)
