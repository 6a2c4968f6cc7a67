"""Attention of the LMs: q/k/v/o projections with the optional QKV bias
and the optional per-head RMSNorm of q and k (``qk_norm``, qwen3-style);
causal self-attention for training, causal prefill that also emits the
KV cache, and the single-token slot decode against that cache; and the
encoder-decoder's cross attention (no RoPE, not causal, keys and values
projected from the encoder output), whole or, at decode, from the cached
cross k/v.  The encoder's own self-attention is ``self_attention`` with
``causal=False``.

The JAX package's ``models/attention.py`` computes attention in XLA,
outside any Pallas kernel, so the port computes it in plain PyTorch, with
the reference's algorithm and execution knobs (``configs/base.py``):

  * ``chunked_attention``: flash-style attention that never holds the
    (S, T) score matrix.  The forward streams the keys in chunks of
    ``attn_chunk_k`` with a running (max, sum, acc) triple in f32
    (``_chunk_accumulate``); the backward (``_FlashAttention``, the
    reference's custom VJP) keeps only (q, k, v, out, lse) and recomputes
    each chunk's probabilities from the lse, with ``delta = sum do * out``,
    so live memory is O(S * (hd + Ck)).  Masked scores are ``NEG_INF``
    (-1e30), or -3e38 in bf16 scores, never -inf; keys padded up to a
    whole chunk sit at position 2**30 and are invalid (``_blockify``).
    ``attn_bf16_scores`` keeps the score chain in q's dtype, the running
    statistics f32.
  * ``chunked_attention_causal_skip`` (``causal_skip``): a loop over q
    chunks of ``attn_chunk_q`` rows, each attending only to the keys up
    to its own end (S must divide into q chunks).
  * ``naive_attention``: the oracle, every score held, softmax in f32.

Training self-attention takes ``attn_impl``'s path (naive, causal_skip or
chunked); the prefill is always chunked (or causal_skip); the encoder's
self-attention is non-causal chunked; the cross attention is chunked over
the frames in train and prefill.  Single-token decode attends to the
whole cache at once (``_attend``), as the reference's decode does, and so
does its read of the cached cross k/v.  Weights keep the reference's
layout: ``wq`` (D, H, hd), ``wk`` / ``wv`` (D, KV, hd), ``wo`` (H, hd,
D), biases (H, hd) / (KV, hd), the q/k norm gains (hd,).  The chunked
paths group q by kv head, (B, S, KV, G, hd) with G = H / KV, where the
reference repeats k and v to H heads: the same products, without the
copy.

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

NEG_INF = -1e30
# a masked score in a bf16 score chain (the reference's constant)
NEG_INF_BF16 = -3e38
# the position of a key padded up to a whole chunk
PAD_POS = 2 ** 30


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
    """Decode: q (B, 1, H, hd) over every key of k / v (B, T, KV, hd) at
    once (``naive_attention``; query head h reads kv head h // (H / KV)),
    valid (B, 1, T) bool or None (every key) -> (B, 1, H, hd)."""
    B, S, H, hd = q.shape
    o = naive_attention(q.reshape(B, S, k.shape[2], -1, hd), k, v,
                        causal=False,
                        kv_valid=None if valid is None else valid[:, 0])
    return o.reshape(B, S, H, hd)


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


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_pos=None, kv_pos=None,
                    kv_valid=None) -> torch.Tensor:
    """The oracle, every score held: q (B, S, KV, G, hd), k / v (B, T,
    KV, hd), q_pos (B, S) and kv_pos (B, T) int (read when ``causal``),
    kv_valid (B, T) bool or None -> (B, S, KV, G, hd) in q's dtype.
    Scores and softmax in f32, masked scores NEG_INF."""
    hd = q.shape[-1]
    s = (torch.einsum("bskgh,btkh->bskgt", q, k) / math.sqrt(hd)).float()
    if causal:
        mask = (q_pos[:, :, None, None, None]
                >= kv_pos[:, None, None, None, :])
        s = s.masked_fill(~mask, NEG_INF)
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bskgt,btkh->bskgh", w, v)


def _heads_first(q: torch.Tensor) -> torch.Tensor:
    """q (B, S, KV, G, hd) -> (B * KV, S * G, hd), contiguous."""
    B, S, KV, G, hd = q.shape
    return q.permute(0, 2, 1, 3, 4).reshape(B * KV, S * G, hd)


def _blockify(k: torch.Tensor, v: torch.Tensor, kv_pos, kv_valid,
              chunk_k: int):
    """The keys in whole chunks of Ck = min(chunk_k, T): k / v (B, T, KV,
    hd) heads first, (B * KV, n_c * Ck, hd), zero-padded; a padded key
    sits at PAD_POS and is invalid.  Returns (kh, vh, kp, bad, Ck):
    kp the keys' positions (B, 1, 1, 1, n_c, Ck) (None when kv_pos is,
    not causal), bad their invalid flags, same shape (None when every key
    is valid)."""
    B, T, KV, hd = k.shape
    Ck = min(chunk_k, T)
    n_c = -(-T // Ck)
    pad = n_c * Ck - T
    kh, vh = (t.permute(0, 2, 1, 3) for t in (k, v))
    if pad:
        kh, vh = (torch.cat([t, t.new_zeros(B, KV, pad, hd)], dim=2)
                  for t in (kh, vh))
        if kv_valid is None:
            kv_valid = torch.ones(B, T, dtype=torch.bool, device=k.device)
        kv_valid = torch.cat([kv_valid, kv_valid.new_zeros(B, pad)], dim=1)
        if kv_pos is not None:
            kv_pos = torch.cat([kv_pos, kv_pos.new_full((B, pad), PAD_POS)],
                               dim=1)
    kh, vh = (t.reshape(B * KV, n_c * Ck, hd) for t in (kh, vh))

    def per_chunk(t):
        return None if t is None else t.reshape(B, 1, 1, 1, n_c, Ck)

    bad = None if kv_valid is None else per_chunk(~kv_valid)
    return kh, vh, per_chunk(kv_pos), bad, Ck


def _drop_for(causal: bool, qp, kp, bad, i: int):
    """Which scores of kv chunk i to mask, (B, 1, S, 1, Ck) bool against
    scores (B, KV, S, G, Ck), or None: the invalid keys and, when
    ``causal``, the keys past each query's position (qp (B, 1, S, 1, 1));
    the reference's ``_mask_for``, negated."""
    drop = qp < kp[..., i, :] if causal else None
    if bad is not None:
        drop = bad[..., i, :] if drop is None else drop | bad[..., i, :]
    return drop


def _scores(qh, k_c, scale, sdt, drop, shape5, div: bool):
    """One chunk's scores (B, KV, S, G, Ck) in ``sdt``, masked to
    NEG_INF (-3e38 in bf16).  ``div``: divided by sqrt(hd), as the
    reference's forward; else times its reciprocal, as its backward.
    The product itself is never written to (``remat="dots"`` may keep
    it)."""
    s = torch.bmm(qh, k_c.transpose(1, 2))
    s = (s / scale if div else s * scale).to(sdt).view(*shape5, -1)
    if drop is not None:
        s.masked_fill_(drop, NEG_INF if sdt == torch.float32
                       else NEG_INF_BF16)
    return s


def _chunk_accumulate(qh, k_c, v_c, m, l, acc, drop,
                      bf16_scores: bool = False):
    """One flash-style step over a kv chunk, in place: qh (B * KV, S * G,
    hd), k_c / v_c (B * KV, Ck, hd); the running max and sum (B, KV, S,
    G) and weighted values (B, KV, S, G, hd), all f32.
    ``bf16_scores`` keeps the (S, Ck) score chain in q's dtype (the
    statistics stay f32)."""
    hd = qh.shape[-1]
    sdt = qh.dtype if bf16_scores else torch.float32
    s = _scores(qh, k_c, math.sqrt(hd), sdt, drop, m.shape, div=True)
    m_new = torch.maximum(m, s.amax(-1).float())
    p = s.sub_(m_new.unsqueeze(-1).to(sdt)).exp_()
    corr = m.sub_(m_new).exp_()            # m is m_new again below
    l.mul_(corr).add_(p.sum(-1).float())
    pv = torch.bmm(p.to(qh.dtype).view(qh.shape[0], qh.shape[1], -1), v_c)
    acc.mul_(corr.unsqueeze(-1)).add_(pv.float().view(acc.shape))
    m.copy_(m_new)


def _flash_fwd_scan(qh, kh, vh, shape5, qp, kp, bad, causal: bool, Ck: int,
                    bf16_scores: bool):
    """out (B, KV, S, G, hd) in q's dtype and lse (B, KV, S, G) f32 over
    the blocked keys (``_blockify``); a row with no valid key has
    lse = inf."""
    m = torch.full(shape5, NEG_INF, dtype=torch.float32, device=qh.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*shape5, qh.shape[-1], dtype=torch.float32,
                      device=qh.device)
    for i, (k_c, v_c) in enumerate(zip(kh.split(Ck, 1), vh.split(Ck, 1))):
        _chunk_accumulate(qh, k_c, v_c, m, l, acc,
                          _drop_for(causal, qp, kp, bad, i), bf16_scores)
    out = (acc / torch.clamp(l, min=1e-30).unsqueeze(-1)).to(qh.dtype)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, math.inf))
    return out, lse


def _query_positions(q_pos, causal: bool):
    """q_pos (B, S) as (B, 1, S, 1, 1), when ``causal``."""
    return q_pos[:, None, :, None, None] if causal else None


class _FlashAttention(torch.autograd.Function):
    """Flash-style attention with a flash-style backward (the reference's
    ``_flash_attention`` custom VJP): saves (q, k, v, out, lse), never
    the probabilities; the backward recomputes each chunk's p from the
    lse."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, causal, chunk_k,
                bf16_scores):
        B, S, KV, G, hd = q.shape
        kh, vh, kp, bad, Ck = _blockify(k, v, kv_pos, kv_valid, chunk_k)
        out, lse = _flash_fwd_scan(_heads_first(q), kh, vh, (B, KV, S, G),
                                   _query_positions(q_pos, causal), kp, bad,
                                   causal, Ck, bf16_scores)
        out = out.permute(0, 2, 1, 3, 4).contiguous()
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid, out, lse)
        ctx.knobs = (causal, chunk_k, bf16_scores)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, kv_valid, out, lse = ctx.saved_tensors
        causal, chunk_k, bf16_scores = ctx.knobs
        B, S, KV, G, hd = q.shape
        T = k.shape[1]
        shape5 = (B, KV, S, G)
        kh, vh, kp, bad, Ck = _blockify(k, v, kv_pos, kv_valid, chunk_k)
        qp = _query_positions(q_pos, causal)
        qh, doh = _heads_first(q), _heads_first(do.to(q.dtype))
        scale = 1.0 / math.sqrt(hd)
        sdt = q.dtype if bf16_scores else torch.float32
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1, 3)
        lse = lse.unsqueeze(-1).to(sdt)
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for i, (k_c, v_c) in enumerate(zip(kh.split(Ck, 1),
                                           vh.split(Ck, 1))):
            s = _scores(qh, k_c, scale, sdt, _drop_for(causal, qp, kp, bad, i),
                        shape5, div=False)
            p = s.sub_(lse).float().exp_()
            pb = p.to(q.dtype).view(B * KV, S * G, Ck)
            dvs.append(torch.bmm(pb.transpose(1, 2), doh))
            dp = torch.bmm(doh, v_c.transpose(1, 2)).float().view(p.shape)
            ds = dp.sub_(delta.unsqueeze(-1)).mul_(p).mul_(scale)
            ds = ds.to(q.dtype).view(B * KV, S * G, Ck)
            dq.add_(torch.bmm(ds, k_c).float())
            dks.append(torch.bmm(ds.transpose(1, 2), qh))

        def back(chunks, like):
            t = torch.cat(chunks, dim=1)[:, :T].view(B, KV, T, hd)
            return t.permute(0, 2, 1, 3).to(like.dtype)

        dq = dq.view(B, KV, S, G, hd).permute(0, 2, 1, 3, 4).to(q.dtype)
        return (dq, back(dks, k), back(dvs, v), None, None, None, None,
                None, None)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, chunk_k: int, q_pos=None,
                      kv_pos=None, kv_valid=None,
                      bf16_scores: bool = False) -> torch.Tensor:
    """Flash-style attention (``_FlashAttention``): q (B, S, KV, G, hd),
    k / v (B, T, KV, hd), q_pos (B, S) / kv_pos (B, T) int positions (read
    when ``causal``), kv_valid (B, T) bool or None -> (B, S, KV, G, hd) in
    q's dtype.  Never holds the (S, T) scores: kv chunks of ``chunk_k``,
    the last one padded."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, kv_valid, causal,
                                 chunk_k, bf16_scores)


def chunked_attention_causal_skip(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, chunk_q: int,
                                  chunk_k: int, q_pos, kv_pos,
                                  kv_valid=None) -> torch.Tensor:
    """Triangular chunked attention: each q chunk of ``chunk_q`` rows
    attends only to the keys up to its own end, saving the rectangle's
    masked half.  q and the keys are position-aligned (self-attention:
    q_pos == kv_pos), and S must divide into q chunks (else
    ``ValueError``).  As in the reference, the scores stay f32."""
    S = q.shape[1]
    Cq = min(chunk_q, S)
    n_q = -(-S // Cq)
    if n_q * Cq != S:
        raise ValueError(f"causal_skip requires S % chunk_q == 0, got S = "
                         f"{S}, chunk_q = {Cq}")
    outs = []
    for i in range(n_q):
        sl, end = slice(i * Cq, (i + 1) * Cq), (i + 1) * Cq
        outs.append(chunked_attention(
            q[:, sl], k[:, :end], v[:, :end], causal=True, chunk_k=chunk_k,
            q_pos=q_pos[:, sl], kv_pos=kv_pos[:, :end],
            kv_valid=None if kv_valid is None else kv_valid[:, :end]))
    return torch.cat(outs, dim=1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: ModelConfig, positions, causal: bool,
               impl: str) -> torch.Tensor:
    """q (B, S, H, hd) over k / v (B, T, KV, hd), H a multiple of KV ->
    (B, S, H, hd): ``impl`` "naive" (the oracle) or "chunked", which is
    ``causal_skip``'s triangle when ``cfg.causal_skip`` and the attention
    is causal.  ``positions`` (B, S) are the queries' and the keys'
    (self-attention; None for the cross attention, which masks
    nothing)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    if impl == "naive":
        o = naive_attention(qg, k, v, causal=causal, q_pos=positions,
                            kv_pos=positions)
    elif causal and cfg.causal_skip:
        o = chunked_attention_causal_skip(
            qg, k, v, chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
            q_pos=positions, kv_pos=positions)
    else:
        o = chunked_attention(qg, k, v, causal=causal,
                              chunk_k=cfg.attn_chunk_k, q_pos=positions,
                              kv_pos=positions,
                              bf16_scores=cfg.attn_bf16_scores)
    return o.reshape(B, S, H, hd)


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
    causal unless ``causal=False`` (the encoder), no cache kept, by
    ``cfg.attn_impl``'s path; returns (B, S, D).  ``dist``:
    tensor-parallel over the mesh's model axis."""
    return _self_attention(p, cfg, x, positions, dist, causal,
                           cfg.attn_impl)[0]


def self_attention_with_cache(p: Attention, cfg: ModelConfig,
                              x: torch.Tensor, positions: torch.Tensor,
                              dist=None, causal: bool = True
                              ) -> tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """Prefill: self-attention over x (B, S, D) at ``positions`` (B, S),
    causal unless ``causal=False``, always chunked (or ``causal_skip``'s
    triangle), as the reference's prefill, whatever ``attn_impl`` says;
    also returns the layer's compact KV cache {"k", "v"} (B, S, KV, hd)
    in x's dtype.  ``dist``: tensor-parallel over the mesh's model axis
    (the module's docstring); the cache then holds the rank's kv heads,
    or all of them where they replicate."""
    return _self_attention(p, cfg, x, positions, dist, causal, "chunked")


def _self_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, dist, causal: bool, impl: str):
    tp = _tp(p, cfg, dist)
    if tp is not None:
        x = collectives.copy_to_model(x, tp)
    q, k, v = _project_qkv(p, cfg, x, positions, tp)
    ka, va = _local_kv(k, v, cfg, tp, q.shape[2])
    o = _attention(q, ka, va, cfg, positions, causal, impl)
    return _out(p, o, tp), {"k": k, "v": v}


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
                       seq=None, decode: bool = False) -> torch.Tensor:
    """Cross attention of the decoder states x (B, S, D) over the encoder
    frames' keys and values k / v (B, T, KV, hd), every frame (no mask,
    no RoPE); returns (B, S, D).  Chunked over the frames in train and
    prefill; at ``decode`` (S = 1, ``k`` and ``v`` the cached ones: the
    reference's ``encdec._dec_block`` decode branch) every frame at once,
    as the reference.  ``dist`` and ``seq`` (decode) as in
    ``decode_self_attention``: k / v are then the rank's kv heads and,
    with ``seq``, its slice of the frames."""
    tp = _tp(p, cfg, dist)
    if tp is not None:
        x = collectives.copy_to_model(x, tp)
    q = _project_q(p, cfg, x, tp)
    k, v = _local_kv(k, v, cfg, tp, q.shape[2])
    k, v = k.to(x.dtype), v.to(x.dtype)
    if seq is not None:
        o = _attend_seq(q, k, v, None, seq, dist)
    elif decode:
        o = _attend(q, k, v, None)
    else:
        o = _attention(q, k, v, cfg, None, False, "chunked")
    return _out(p, o, tp)


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    kv_x: torch.Tensor, dist=None) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): queries from x
    (B, S, D), keys and values projected from the encoder output kv_x
    (B, T, D).  No RoPE, no causality; returns (B, S, D)."""
    k, v = cross_kv(p, cfg, kv_x, dist)
    return cross_attention_kv(p, cfg, x, k, v, dist)
