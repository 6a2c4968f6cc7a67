"""Shared neural building blocks: initialisers, RMSNorm, LayerNorm, RoPE,
SwiGLU (the function, the module holding its weights, ``swiglu_apply``
and ``swiglu_module``, which runs it tensor-parallel under a mesh's
``model`` axis: each rank holds d_ff / n columns of ``w_gate`` / ``w_up``
and the matching rows of ``w_down``, and the row-parallel output is
all-reduced).

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

from repro_torch.launch import collectives


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
             eps: float = 1e-6, dist=None) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 and cast back to x's
    dtype (``scale`` is the f32 (D,) gain).  Under ``dist`` the last axis
    is this rank's equal slice of one split over ``model``: the sum of
    squares is all-reduced both ways (``collectives.all_reduce_model``)
    and the mean taken over the whole width."""
    dt = x.dtype
    x = x.float()
    ss = collectives.all_reduce_model(x.square().sum(-1, keepdim=True), dist)
    width = x.shape[-1] * (1 if dist is None else dist.n_model)
    return (x * torch.rsqrt(ss / width + eps) * scale).to(dt)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (mean and biased variance), computed
    in f32 and cast back to x's dtype (``scale`` and ``bias`` are the f32
    (D,) gain and shift; the reference's init is ones and zeros)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


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


class SwiGLU(nn.Module):
    """The dense FFN's weights (reference layout: (D, F), (D, F), (F, D))."""

    def __init__(self, d_model: int, d_ff: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w_gate = nn.Parameter(
            truncated_normal((d_model, d_ff), 1.0, generator))
        self.w_up = nn.Parameter(
            truncated_normal((d_model, d_ff), 1.0, generator))
        self.w_down = nn.Parameter(
            truncated_normal((d_ff, d_model), 1.0, generator))



def swiglu_apply(ffn: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """``swiglu`` with ``ffn``'s weights.  A function, not the module's
    ``forward``: a block calls no module, so nothing that hooks modules
    (``FlopCounterMode``'s tracker) holds on to a remat recompute."""
    return swiglu(ffn.w_gate, ffn.w_up, ffn.w_down, x)


def swiglu_module(ffn: SwiGLU, x: torch.Tensor, d_ff: int,
                  dist=None) -> torch.Tensor:
    """``swiglu_apply(ffn, x)``, where the FFN's full hidden width is
    ``d_ff``.  Under a
    model axis of more than one, with ``ffn`` holding its local d_ff
    columns, tensor-parallel: x's gradient is summed over the axis
    (``copy_to_model``) and the row-parallel output's parts are summed
    (``reduce_from_model``).  An FFN whose d_ff did not divide the axis
    holds all of it and runs whole on every rank."""
    if dist is None or dist.n_model == 1 or ffn.w_gate.shape[1] == d_ff:
        return swiglu_apply(ffn, x)
    x = collectives.copy_to_model(x, dist)
    return collectives.reduce_from_model(swiglu_apply(ffn, x), dist)
