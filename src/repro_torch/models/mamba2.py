"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) mixer.

Ported from the JAX package's ``models/mamba2.py``, which computes the
SSD scan outside any Pallas kernel, so the port computes it in plain
PyTorch: the chunked matmul decomposition (intra-chunk quadratic,
attention-like (Q x Q) tiles, plus an inter-chunk linear recurrence, the
reference's ``lax.scan`` here a Python loop over the chunks) by
``einsum``.  The chunk length is ``MambaConfig.chunk``.

The projections are separate (z / x / B / C / dt), as in the reference
(its tensor-parallel layout), with its weight layout: (D, out) matrices,
depthwise convs ``conv_{x,b,c}`` {w (d_conv, ch), b (ch,)}, ``A_log``,
``D`` and ``dt_bias`` per head, the gated RMSNorm gain ``norm`` (d_in,)
and ``out_proj`` (d_in, D).

Decode is the O(1)-state recurrence h' = exp(dt·A) h + dt · B ⊗ x over a
cache {"ssm" (B, H, N, P), "conv_x" / "conv_b" / "conv_c" (B, d_conv - 1,
ch)}, updated in place (the slot pool's caches are the engine's state).
One repair over the reference: its prefill cache keeps the last
d_conv - 1 raw inputs by a slice that starts before 0 when the prompt is
shorter than d_conv - 1, so the history comes out short; here it is
left-padded with zeros, the state a sequence starts from, so prefill then
decode equals the sequential oracle ``mamba_reference`` at every length.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    n_heads = d_in // mc.head_dim
    gn = mc.n_groups * mc.d_state
    return mc, d_in, n_heads, gn


class Conv(nn.Module):
    """A depthwise causal conv's weights: ``w`` (d_conv, ch), ``b`` (ch,)."""

    def __init__(self, d_conv: int, ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(
            layers.truncated_normal((d_conv, ch), 1.0, generator))
        self.b = nn.Parameter(torch.zeros(ch))


class Mamba2(nn.Module):
    """One Mamba-2 mixer's weights, drawn as the reference draws them (its
    distributions, not its numbers)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc, d_in, n_heads, gn = _dims(cfg)
        D = cfg.d_model

        def w(d_i, d_o):
            return nn.Parameter(
                layers.truncated_normal((d_i, d_o), 1.0, generator))

        self.z_proj = w(D, d_in)
        self.x_proj = w(D, d_in)
        self.b_proj = w(D, gn)
        self.c_proj = w(D, gn)
        self.dt_proj = w(D, n_heads)
        self.conv_x = Conv(mc.d_conv, d_in, generator)
        self.conv_b = Conv(mc.d_conv, gn, generator)
        self.conv_c = Conv(mc.d_conv, gn, generator)
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0,
                                                           n_heads)))
        self.D = nn.Parameter(torch.ones(n_heads))
        # dt ~ log-uniform in [1e-3, 1e-1]; dt_bias = softplus^-1(dt)
        u = torch.rand(n_heads, generator=generator)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(dt)))
        self.norm = nn.Parameter(torch.ones(d_in))
        self.out_proj = w(d_in, D)


def _causal_conv(conv: Conv, x: torch.Tensor, dtype) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, ch) via shifted adds (d_conv is
    tiny), then SiLU."""
    w, b = conv.w.to(dtype), conv.b.to(dtype)
    d_conv = w.shape[0]
    out = x * w[-1]
    for i in range(1, d_conv):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan from a zero state.

    x:  (B, S, H, P)    head inputs
    dt: (B, S, H)       positive step sizes (softplus applied), f32
    A:  (H,)            negative decay rates
    Bm: (B, S, G, N)    input projections  (broadcast over H // G heads)
    Cm: (B, S, G, N)    output projections
    Returns (y (B, S, H, P), h_final (B, H, N, P)).
    """
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    if nc * Q != S:
        raise ValueError(f"seq {S} must be divisible by chunk {Q}")
    xdt = x.dtype

    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A                                  # (B,nc,Q,H), negative
    cs = torch.cumsum(dA, dim=2)                  # within-chunk cumulative
    total = cs[:, :, -1]                          # (B,nc,H)

    # intra-chunk quadratic: y_i += sum_{j<=i} (C_i.B_j) e^{cs_i-cs_j} dt_j x_j
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (B,nc,Qi,Qj,H)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(decay), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L.to(xdt)
    y = torch.einsum("bcijh,bcjhp->bcihp",
                     scores * dtc.to(xdt)[:, :, None], xc)

    # chunk summary state: S_c = sum_j e^{total - cs_j} dt_j B_j ⊗ x_j
    w = torch.exp(total[:, :, None] - cs) * dtc               # (B,nc,Q,H)
    chunk_states = torch.einsum("bcjhn,bcjhp->bchnp",
                                Bc * w.to(xdt)[..., None], xc)

    # inter-chunk recurrence over nc
    h = torch.zeros((Bsz, H, N, Pd), dtype=xdt, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None].to(xdt) \
            + chunk_states[:, c]
    h_prevs = torch.stack(h_prevs, 1)                         # (B,nc,H,N,P)

    # contribution of the carried state to each position in its chunk
    y_state = torch.einsum("bcihn,bchnp->bcihp",
                           Cc * torch.exp(cs)[..., None].to(xdt), h_prevs)
    y = (y + y_state).reshape(Bsz, S, H, Pd)
    return y, h


def _project(p: Mamba2, x: torch.Tensor):
    """x (..., D) -> z, xs, Bm, Cm, dt_raw (pre-softplus)."""
    dt_ = x.dtype
    return (x @ p.z_proj.to(dt_), x @ p.x_proj.to(dt_),
            x @ p.b_proj.to(dt_), x @ p.c_proj.to(dt_),
            x @ p.dt_proj.to(dt_))


def _history(raw: torch.Tensor, n: int) -> torch.Tensor:
    """The last n rows of raw (B, S, ch), left-padded with zeros when
    S < n (the reference slices from S - n, short for S < n)."""
    return F.pad(raw, (0, 0, n, 0))[:, raw.shape[1]:]


def mamba_apply(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                return_cache: bool = False):
    """Full-sequence Mamba-2 mixer. x: (B, S, D) -> (B, S, D); with
    ``return_cache`` also the decode cache after the last position."""
    mc, d_in, n_heads, gn = _dims(cfg)
    dt_ = x.dtype
    B, S, D = x.shape
    z, xs_raw, Bm_raw, Cm_raw, dt_raw = _project(p, x)
    xs = _causal_conv(p.conv_x, xs_raw, dt_)
    Bm = _causal_conv(p.conv_b, Bm_raw, dt_)
    Cm = _causal_conv(p.conv_c, Cm_raw, dt_)
    xs_h = xs.reshape(B, S, n_heads, mc.head_dim)
    Bm = Bm.reshape(B, S, mc.n_groups, mc.d_state)
    Cm = Cm.reshape(B, S, mc.n_groups, mc.d_state)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    # pad S to a chunk multiple: zero dt/x/B/C => exp(0)=1 decay, zero
    # state contribution — the padded tail is a mathematical no-op
    Q = min(mc.chunk, S)
    pad = (-S) % Q
    xs_p, Bm_p, Cm_p, dt_p = xs_h, Bm, Cm, dt
    if pad:
        def zpad(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        xs_p, Bm_p, Cm_p, dt_p = zpad(xs_h), zpad(Bm), zpad(Cm), zpad(dt)
    y, h_final = _ssd_chunked(xs_p, dt_p, A, Bm_p, Cm_p, mc.chunk)
    y = y[:, :S] + xs_h * p.D.to(dt_)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = layers.rms_norm(p.norm, y * F.silu(z), cfg.norm_eps)
    out = y @ p.out_proj.to(dt_)
    if not return_cache:
        return out
    nc = mc.d_conv - 1
    cache = {"ssm": h_final.to(dt_),
             "conv_x": _history(xs_raw, nc).to(dt_),
             "conv_b": _history(Bm_raw, nc).to(dt_),
             "conv_c": _history(Cm_raw, nc).to(dt_)}
    return out, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    mc, d_in, n_heads, gn = _dims(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"ssm": z(batch, n_heads, mc.d_state, mc.head_dim),
            "conv_x": z(batch, mc.d_conv - 1, d_in),
            "conv_b": z(batch, mc.d_conv - 1, gn),
            "conv_c": z(batch, mc.d_conv - 1, gn)}


def _conv_step(conv: Conv, hist_new: torch.Tensor, dtype) -> torch.Tensor:
    """hist_new: (B, d_conv, ch) — the last d_conv raw inputs incl. the
    current one."""
    return F.silu((hist_new * conv.w.to(dtype)[None]).sum(1)
                  + conv.b.to(dtype))


def mamba_decode_step(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor]):
    """Single-token decode. x: (B, 1, D); O(1) state update.  Writes the
    new state into ``cache`` in place; returns (out (B, 1, D), cache)."""
    mc, d_in, n_heads, gn = _dims(cfg)
    dt_ = x.dtype
    B = x.shape[0]
    z, xs_raw, Bm_raw, Cm_raw, dt_raw = _project(p, x[:, 0])
    hx = torch.cat([cache["conv_x"].to(dt_), xs_raw[:, None]], 1)
    hb = torch.cat([cache["conv_b"].to(dt_), Bm_raw[:, None]], 1)
    hc = torch.cat([cache["conv_c"].to(dt_), Cm_raw[:, None]], 1)
    xs = _conv_step(p.conv_x, hx, dt_).reshape(B, n_heads, mc.head_dim)
    rep = n_heads // mc.n_groups
    Bm = _conv_step(p.conv_b, hb, dt_).reshape(
        B, mc.n_groups, mc.d_state).repeat_interleave(rep, dim=1)
    Cm = _conv_step(p.conv_c, hc, dt_).reshape(
        B, mc.n_groups, mc.d_state).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A).to(dt_)                     # (B,H)
    h = cache["ssm"].to(dt_)                              # (B,H,N,P)
    dBx = (dt.to(dt_)[..., None, None]
           * Bm[..., :, None] * xs[..., None, :])         # (B,H,N,P)
    h = h * decay[..., None, None] + dBx
    y = torch.einsum("bhn,bhnp->bhp", Cm, h)              # (B,H,P)
    y = y + xs * p.D.to(dt_)[None, :, None]
    y = y.reshape(B, 1, d_in)
    y = layers.rms_norm(p.norm, y * F.silu(z[:, None]), cfg.norm_eps)
    out = y @ p.out_proj.to(dt_)
    cache["ssm"].copy_(h)
    cache["conv_x"].copy_(hx[:, 1:])
    cache["conv_b"].copy_(hb[:, 1:])
    cache["conv_c"].copy_(hc[:, 1:])
    return out, cache


def mamba_reference(p: Mamba2, cfg: ModelConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Sequential-scan oracle of the chunked SSD path: decode step by step
    from a zero f32 cache."""
    B, S, D = x.shape
    cache = init_mamba_cache(cfg, B, dtype=torch.float32, device=x.device)
    outs = []
    for t in range(S):
        y, cache = mamba_decode_step(p, cfg, x[:, t:t + 1], cache)
        outs.append(y)
    return torch.cat(outs, dim=1)
