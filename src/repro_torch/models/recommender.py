"""Feed-forward recommenders (paper Sec. 4.2 architectures).

A thin MLP over an IOEmbedding (``core/alternatives.py``: Bloom, HT, ECOC,
PMI, CCA): encode(p) -> hidden ReLU layers -> m_out logits, trained with
the embedding's own loss (``recommender_loss``) and evaluated after its
decode back to item space (``recommender_scores``).  The JAX package keeps
the tower as a ``{"l0": {"w", "b"}, ...}`` pytree; here it is an
``nn.Module`` whose layer i is ``layers[i]``, and ``params_from_jax``
loads the reference's tree into it.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers


class FFTower(nn.Module):
    """Linear layers of widths ``[d_in, *hidden, d_out]``, ReLU between."""

    def __init__(self, d_in: int, hidden: Sequence[int], d_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [d_in, *hidden, d_out]
        self.layers = nn.ModuleList(
            layers.dense_init(dims[i], dims[i + 1], generator=generator)
            for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = torch.relu(x)
        return x


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    device) -> FFTower:
    """The reference's ``ff_init`` tree ``{"l{i}": {"w": (in, out),
    "b": (out,)}}`` (numpy arrays) as an FFTower on ``device``; the
    (in, out) weights are transposed to nn.Linear's (out, in) here."""
    n = len(tree)
    ws = [np.asarray(tree[f"l{i}"]["w"], np.float32) for i in range(n)]
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    tower = FFTower(dims[0], dims[1:-1], dims[-1])
    with torch.no_grad():
        for i, layer in enumerate(tower.layers):
            layer.weight.copy_(torch.tensor(ws[i].T))
            layer.bias.copy_(torch.tensor(
                np.asarray(tree[f"l{i}"]["b"], np.float32)))
    return tower.to(device)


def recommender_init(emb, hidden: Sequence[int],
                     generator: torch.Generator | None = None,
                     device=None) -> FFTower:
    """An FFTower from ``emb.m_in`` through ``hidden`` to ``emb.m_out``,
    drawn on the CPU from ``generator`` and moved to ``device`` (CUDA unless
    the caller asks for the CPU)."""
    tower = FFTower(emb.m_in, hidden, emb.m_out, generator=generator)
    return tower.to(resolve_device(device))


def recommender_loss(model: FFTower, emb, p_in: torch.Tensor,
                     q_out: torch.Tensor) -> torch.Tensor:
    """p_in / q_out: padded item-id sets (B, c_max). Mean loss over the
    batch."""
    pred = model(emb.encode_input(p_in))
    return emb.loss(pred, q_out).mean()


def recommender_scores(model: FFTower, emb,
                       p_in: torch.Tensor) -> torch.Tensor:
    """(B, c_max) -> (B, d) item ranking scores via the embedding's
    decode."""
    return emb.decode(model(emb.encode_input(p_in)))
