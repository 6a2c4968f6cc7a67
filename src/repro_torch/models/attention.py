"""Attention of the LMs: q/k/v/o projections with the optional QKV bias
and the optional per-head RMSNorm of q and k (``qk_norm``, qwen3-style);
causal self-attention for training, causal prefill that also emits the
KV cache, and the single-token slot decode against that cache; and the
encoder-decoder's cross attention (no RoPE, not causal, keys and values
projected from the encoder output), whole or, at decode, from the cached
cross k/v.  The encoder's own self-attention is ``self_attention`` with
``causal=False``.

The JAX package's ``models/attention.py`` computes attention in XLA,
outside any Pallas kernel, so the port computes it in plain PyTorch
(matmuls and an f32 softmax), and training differentiates it by autograd
where the reference has a chunked flash-style ``custom_vjp``.  Weights
keep the reference's layout: ``wq`` (D, H, hd), ``wk`` / ``wv``
(D, KV, hd), ``wo`` (H, hd, D), biases (H, hd) / (KV, hd), the q/k
norm gains (hd,).  The reference's flash-style chunking is not
ported: it serves the memory limits of long sequences.

Tensor parallel (a mesh's ``model`` axis of more than one, train,
prefill and decode): the layer holds its rank's heads, as the reference's specs
place them: ``wq`` (D, H/n, hd), ``wo`` (H/n, hd, D), ``bq`` (H/n, hd),
and ``wk`` / ``wv`` / ``bk`` / ``bv`` over KV/n heads when ``num_kv_heads``
divides the axis, else whole (GQA kv replication).  The layer's input
enters through ``copy_to_model`` (its gradient summed over the axis),
every replicated weight used by the rank's heads alone (the q/k norm
gains, replicated k/v projections) too, each rank attends with its own
heads (with replicated k/v, the kv heads its q heads read), and the
output projection's parts are summed (``reduce_from_model``).  A layer
whose heads do not divide the axis holds every head and runs whole on
every rank, with no reduce after ``wo``.  The encoder's self-attention
and the cross attention split the same way.

At decode the cache is the rank's shard of ``sharding.cache_pspecs``.
Where its sequence splits (over ``model`` when neither the heads nor the
kv heads divide the axis, over the batch axes when the batch does not
divide them) the caller passes the rank's slice (``seq``, a
``sharding.SeqShard``): the new k/v is written only by the rank that
holds position ``pos``, keys are masked by their global position, and
each rank's softmax partials over its slice (max, sum, weighted values;
a slice with no valid key gives a max of -inf and weighs 0) are merged
across the slices (``collectives.softmax_combine``).  The combine has
no host sync and no data-dependent shape, so it runs on ``meta``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
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
            self.q_norm = nn.Parameter(torch.ones(hd))
            self.k_norm = nn.Parameter(torch.ones(hd))


def _tp(p: Attention, cfg: ModelConfig, dist):
    """``dist`` when this layer holds only its rank's heads, else None."""
    if dist is None or dist.n_model == 1 or p.wq.shape[1] == cfg.num_heads:
        return None
    return dist


def _rep(w: torch.Tensor, tp) -> torch.Tensor:
    """A replicated weight used by the rank's heads alone: its gradient
    is summed over the model axis."""
    return w if tp is None else collectives.copy_to_model(w, tp)


def _project_q(p: Attention, cfg: ModelConfig,
               x: torch.Tensor, tp=None) -> torch.Tensor:
    """x (B, S, D) -> q (B, S, H, hd): biased, RMS-normed per head
    (``qk_norm``); no RoPE.  H is the rank's heads under ``tp``."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
    if cfg.qk_norm:
        q = layers.rms_norm(_rep(p.q_norm, tp), q, cfg.norm_eps)
    return q


def project_kv(p: Attention, cfg: ModelConfig, x: torch.Tensor, tp=None):
    """x (B, T, D) -> k and v (B, T, KV, hd): biased, k RMS-normed per
    head (``qk_norm``); no RoPE (the cross attention's keys and values
    as the decode cache holds them).  KV is the rank's kv heads under
    ``tp`` when they are split, else all of them."""
    dt = x.dtype
    kv_rep = tp is not None and p.wk.shape[1] == cfg.num_kv_heads

    def w(t):
        return _rep(t, tp) if kv_rep else t

    k = torch.einsum("bsd,dhk->bshk", x, w(p.wk).to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, w(p.wv).to(dt))
    if cfg.qkv_bias:
        k = k + w(p.bk).to(dt)
        v = v + w(p.bv).to(dt)
    if cfg.qk_norm:
        k = layers.rms_norm(_rep(p.k_norm, tp), k, cfg.norm_eps)
    return k, v


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, tp=None):
    """x (B, S, D) -> q (B, S, H, hd), k and v (B, S, KV, hd): biased,
    q and k RMS-normed per head (``qk_norm``), then RoPE'd, in the
    reference's order."""
    q = _project_q(p, cfg, x, tp)
    k, v = project_kv(p, cfg, x, tp)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, KV, hd), valid (B, S, T) bool or None
    (every key) -> (B, S, H, hd).  Scores and softmax in f32,
    probabilities cast to q's dtype for the value product; KV heads
    repeat to H (GQA)."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    if H != KV:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, ., hd)
    s = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(hd)
    if valid is not None:
        s = s.masked_fill(~valid[:, None], -math.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(w, vh).transpose(1, 2)


def _attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: Optional[torch.Tensor]):
    """Softmax partials of q (B, S, H, hd) over one slice of the keys,
    k/v (B, T, KV, hd), valid (B, S, T) bool or None: (m, l) (B, S, H),
    the slice's largest score and sum of exp(s - m), and o (B, S, H, hd),
    its sum of exp(s - m) v, all f32.  A row with no valid key gives
    m = -inf, l = 0 and o = 0 (its exponents taken against 0, not
    against -inf, which would give NaN)."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    if H != KV:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, ., hd)
    s = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(hd)
    if valid is not None:
        s = s.masked_fill(~valid[:, None], -math.inf)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m,
                                  torch.zeros_like(m))[..., None])
    o = torch.matmul(p, vh.float())
    return m.transpose(1, 2), p.sum(-1).transpose(1, 2), o.transpose(1, 2)


def _attend_seq(q, k, v, valid, seq, dist) -> torch.Tensor:
    """``_attend`` over keys split by sequence: this rank's slice k/v
    (``seq``), merged with the other slices' partials; q's dtype."""
    m, l, o = _attend_partial(q, k, v, valid)
    return collectives.softmax_combine(m, l, o, dist, seq.group).to(q.dtype)


def _local_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, tp,
              n_heads: int):
    """The kv heads the rank's ``n_heads`` q heads read: with replicated
    kv heads under ``tp``, global q head h reads kv head h // (H / KV);
    otherwise k and v as they are."""
    if tp is None or k.shape[2] != cfg.num_kv_heads:
        return k, v
    group = cfg.num_heads // cfg.num_kv_heads
    heads = tp.model_index * n_heads + torch.arange(n_heads, device=k.device)
    idx = heads // group
    return k[:, :, idx], v[:, :, idx]


def _out(p: Attention, o: torch.Tensor, tp=None) -> torch.Tensor:
    y = torch.einsum("bshk,hkd->bsd", o, p.wo.to(o.dtype))
    return y if tp is None else collectives.reduce_from_model(y, tp)


def self_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   causal: bool = True, dist=None) -> torch.Tensor:
    """Train: self-attention over x (B, S, D) at ``positions`` (B, S),
    causal unless ``causal=False`` (the encoder), no cache kept; returns
    (B, S, D).  ``dist``: tensor-parallel over the mesh's model axis."""
    return self_attention_with_cache(p, cfg, x, positions, dist, causal)[0]


def self_attention_with_cache(p: Attention, cfg: ModelConfig,
                              x: torch.Tensor, positions: torch.Tensor,
                              dist=None, causal: bool = True
                              ) -> tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """Prefill: self-attention over x (B, S, D) at ``positions`` (B, S),
    causal unless ``causal=False``, which also returns the layer's compact
    KV cache {"k", "v"} (B, S, KV, hd) in x's dtype.  ``dist``:
    tensor-parallel over the mesh's model axis (the module's docstring);
    the cache then holds the rank's kv heads, or all of them where they
    replicate."""
    tp = _tp(p, cfg, dist)
    if tp is not None:
        x = collectives.copy_to_model(x, tp)
    q, k, v = _project_qkv(p, cfg, x, positions, tp)
    mask = (positions[:, :, None] >= positions[:, None, :] if causal
            else None)
    ka, va = _local_kv(k, v, cfg, tp, q.shape[2])
    return _out(p, _attend(q, ka, va, mask), tp), {"k": k, "v": v}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                          dist=None, seq=None) -> torch.Tensor:
    """Single-token decode of x (B, 1, D) against ``cache`` {"k","v"}
    (B, T, KV, hd), where ``pos`` (B,) int is each row's own sequence
    offset (a continuous-batching slot pool).  Each row's new k/v is
    written at its ``pos`` IN PLACE (the reference returns a new cache;
    updating the pool saves a copy of it per layer per step), and keys at
    positions <= pos are attended.  Returns (B, 1, D).

    ``dist``: tensor-parallel over the mesh's model axis, as prefill is:
    the cache is this rank's shard (``sharding.cache_pspecs``: its kv
    heads, or all of them where they replicate), the new k/v of those
    heads go into it, and each q head reads its kv head.  ``seq``: the
    cache holds slice ``seq.index`` of the sequence, global positions
    [index * T, (index + 1) * T) (the module's docstring)."""
    tp = _tp(p, cfg, dist)
    if tp is not None:
        x = collectives.copy_to_model(x, tp)
    B, T = x.shape[0], cache["k"].shape[1]
    posb = pos.reshape(B, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, posb, tp)
    rows = torch.arange(B, device=x.device)
    lo = 0 if seq is None else seq.index * T
    if seq is None:
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
    else:       # only the rank holding position pos writes it
        at = pos - lo
        owned = ((at >= 0) & (at < T))[:, None, None]
        at = at.clamp(0, T - 1)
        for key, new in (("k", k_new), ("v", v_new)):
            buf = cache[key]
            buf[rows, at] = torch.where(owned, new[:, 0].to(buf.dtype),
                                        buf[rows, at])
    keys = lo + torch.arange(T, device=x.device)
    valid = keys[None, None, :] <= posb[:, :, None]
    ka, va = _local_kv(cache["k"], cache["v"], cfg, tp, q.shape[2])
    ka, va = ka.to(x.dtype), va.to(x.dtype)
    o = (_attend(q, ka, va, valid) if seq is None
         else _attend_seq(q, ka, va, valid, seq, dist))
    return _out(p, o, tp)


def cross_kv(p: Attention, cfg: ModelConfig, kv_x: torch.Tensor,
             dist=None):
    """The cross attention's keys and values (B, T, KV, hd) of the encoder
    output kv_x (B, T, D) (``project_kv``); under a model axis the rank's
    kv heads (or all of them where they replicate), kv_x's gradient summed
    over the axis."""
    tp = _tp(p, cfg, dist)
    if tp is not None:
        kv_x = collectives.copy_to_model(kv_x, tp)
    return project_kv(p, cfg, kv_x, tp)


def cross_attention_kv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, dist=None,
                       seq=None) -> torch.Tensor:
    """Cross attention of the decoder states x (B, S, D) over the encoder
    frames' keys and values k / v (B, T, KV, hd), every frame (no mask,
    no RoPE); returns (B, S, D).  At decode (S = 1) ``k`` and ``v`` are
    the cached ones (the reference's ``encdec._dec_block`` decode
    branch).  ``dist`` and ``seq`` as in ``decode_self_attention``: k / v
    are then the rank's kv heads and, with ``seq``, its slice of the
    frames."""
    tp = _tp(p, cfg, dist)
    if tp is not None:
        x = collectives.copy_to_model(x, tp)
    q = _project_q(p, cfg, x, tp)
    k, v = _local_kv(k, v, cfg, tp, q.shape[2])
    k, v = k.to(x.dtype), v.to(x.dtype)
    o = (_attend(q, k, v, None) if seq is None
         else _attend_seq(q, k, v, None, seq, dist))
    return _out(p, o, tp)


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    kv_x: torch.Tensor, dist=None) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): queries from x
    (B, S, D), keys and values projected from the encoder output kv_x
    (B, T, D).  No RoPE, no causality; returns (B, S, D)."""
    k, v = cross_kv(p, cfg, kv_x, dist)
    return cross_attention_kv(p, cfg, x, k, v, dist)
