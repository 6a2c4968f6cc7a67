"""Shared neural building blocks: the dense layer's initialiser.

The JAX package's ``dense`` layer (``x @ w + b``) is ``nn.Linear`` here,
whose weight is stored transposed, (d_out, d_in).  Weights are initialised
as the JAX package's ``models/layers.py`` draws them — a fan-in-scaled
normal truncated at two standard deviations, zero bias — from a
``torch.Generator``.  The two libraries draw different
numbers from one seed, so tests that compare the two packages load one set
of weights into both (``models.recommender.params_from_jax``).
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

