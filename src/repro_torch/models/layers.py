"""Shared neural building blocks: initialisers, RMSNorm, RoPE, SwiGLU.

The JAX package's ``dense`` layer (``x @ w + b``) is ``nn.Linear`` here,
whose weight is stored transposed, (d_out, d_in).  The transformer's
weights keep the JAX package's (in, out) layout (``models/attention.py``,
``models/transformer.py``), so its params load by plain copies.  Weights
are initialised as the JAX package's ``models/layers.py`` draws them — a
fan-in-scaled normal truncated at two standard deviations, zero bias, and
N(0, 0.02) embeddings — from a ``torch.Generator``.  The two libraries draw
different numbers from one seed, so tests that compare the two packages
load one set of weights into both (``models.recommender.params_from_jax``,
``models.transformer.lm_params_from_jax``).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def truncated_normal_(w: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """In place: stddev = scale / sqrt(fan_in), truncated at ±2 stddev."""
    std = scale / math.sqrt(max(fan_in, 1))
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def dense_init(d_in: int, d_out: int, bias: bool = True, scale: float = 1.0,
               generator: torch.Generator | None = None) -> nn.Linear:
    """A CPU ``nn.Linear`` (weight (d_out, d_in)) with the reference's
    initialisation; the caller moves it to its device."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias)
    truncated_normal_(lin.weight, scale, d_in, generator)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin



def truncated_normal(shape, scale: float,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """A new f32 CPU tensor of ``shape`` (fan-in = ``shape[0]``), drawn as
    ``truncated_normal_`` draws; the reference's (in, out) layout."""
    w = torch.empty(shape, dtype=torch.float32)
    return truncated_normal_(w, scale, shape[0], generator)


def embed_init(shape, generator: torch.Generator | None = None
               ) -> torch.Tensor:
    """N(0, 0.02) f32 CPU tensor of ``shape`` (the embedding table)."""
    return torch.randn(shape, generator=generator) * 0.02


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 and cast back to x's
    dtype (``scale`` is the f32 (D,) gain)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """(head_dim / 2,) f32 inverse frequencies theta^(-2i / head_dim)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions broadcastable to (..., S).  Angles in
    f32, the split-halves layout (x1 = first half, x2 = second half), the
    result cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs      # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]              # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` in x's dtype; weights
    (D, F), (D, F), (F, D)."""
    dt = x.dtype
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    return (torch.nn.functional.silu(g) * u) @ w_down.to(dt)
