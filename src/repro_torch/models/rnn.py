"""GRU / LSTM sequence models (paper tasks: YC session GRU, PTB LSTM).

The JAX package's ``models/rnn.py`` in PyTorch.  Mirrors Hidasi et al.
(GRU4Rec) and Graves-style LSTM LMs: one-hot (or Bloom-encoded) input ->
recurrent core -> softmax over the (possibly Bloom-compressed) output
space.  The reference scans the cell over time with ``lax.scan``; here it
is an explicit loop over time, and the cells keep the reference's gate
layout: GRU gates r, z, n with ``n = tanh(xn + r * hn)``; LSTM gates
i, f, g, o with a constant +1.0 on the forget gate.  (``nn.GRU`` and
``nn.LSTM`` are not used: ``nn.LSTM`` has no +1.0 forget bias, and cuDNN
sums in another order.)

The reference keeps its params as the tree ``{"in_proj": {"w", "b"},
"cell": {"wx", "wh", "b"}, "out": {"w", "b"}}``; here they are an
``RNNLM`` module whose ``in_proj`` and ``out`` are ``nn.Linear`` (weights
transposed, (out, in)) and whose cell keeps the reference's (in, out)
``wx`` and ``wh`` and its bias; ``params_from_jax`` loads the tree.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers

GATES = {"gru": 3, "lstm": 4}


class RNNCell(nn.Module):
    """A GRU or LSTM cell's weights in the reference's layout:
    ``wx`` (d_in, G*d_h), ``wh`` (d_h, G*d_h), ``b`` (G*d_h,), G = 3
    (GRU) or 4 (LSTM)."""

    def __init__(self, cell: str, d_in: int, d_hidden: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = GATES[cell] * d_hidden
        self.wx = nn.Parameter(layers.truncated_normal((d_in, g), 1.0,
                                                       generator))
        self.wh = nn.Parameter(layers.truncated_normal((d_hidden, g), 1.0,
                                                       generator))
        self.b = nn.Parameter(torch.zeros(g))


def gru_cell(params: RNNCell, h: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    xg = x @ params.wx + params.b
    hg = h @ params.wh
    xr, xz, xn = xg.chunk(3, dim=-1)
    hr, hz, hn = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


def lstm_cell(params: RNNCell, carry, x: torch.Tensor):
    h, c = carry
    gates = x @ params.wx + h @ params.wh + params.b
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
    c = f * c + i * torch.tanh(g)
    h = o * torch.tanh(c)
    return (h, c)


class RNNLM(nn.Module):
    """in_proj (d_in -> d_hidden) -> GRU or LSTM cell -> out
    (d_hidden -> d_out)."""

    def __init__(self, cell: str, d_in: int, d_hidden: int, d_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cell not in GATES:
            raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
        self.in_proj = layers.dense_init(d_in, d_hidden, generator=generator)
        self.cell = RNNCell(cell, d_hidden, d_hidden, generator)
        self.out = layers.dense_init(d_hidden, d_out, generator=generator)


def rnn_lm_init(cell: str, d_in: int, d_hidden: int, d_out: int,
                generator: torch.Generator | None = None,
                device=None) -> RNNLM:
    """An RNNLM drawn on the CPU from ``generator`` (the reference's
    initialisers) and moved to ``device`` (CUDA unless the caller asks for
    the CPU)."""
    model = RNNLM(cell, d_in, d_hidden, d_out, generator)
    return model.to(resolve_device(device))


def rnn_lm_apply(model: RNNLM, cell: str, x_seq: torch.Tensor
                 ) -> torch.Tensor:
    """x_seq: (B, T, d_in) encoded inputs -> logits (B, T, d_out)."""
    B, T, _ = x_seq.shape
    x_seq = model.in_proj(x_seq)
    d_h = x_seq.shape[-1]
    h = torch.zeros((B, d_h), dtype=x_seq.dtype, device=x_seq.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(T):
        if cell == "gru":
            h = gru_cell(model.cell, h, x_seq[:, t])
        else:
            h, c = lstm_cell(model.cell, (h, c), x_seq[:, t])
        hs.append(h)
    return model.out(torch.stack(hs, dim=1))


def rnn_lm_last_logits(model: RNNLM, cell: str, x_seq: torch.Tensor
                       ) -> torch.Tensor:
    return rnn_lm_apply(model, cell, x_seq)[:, -1]


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]], cell: str,
                    device) -> RNNLM:
    """The reference's ``rnn_lm_init`` tree (numpy arrays) as an RNNLM on
    ``device``; the dense layers' (in, out) weights are transposed to
    nn.Linear's (out, in), the cell's are copied as they are."""
    def arr(x):
        return torch.tensor(np.asarray(x, np.float32))

    w_in, w_out = np.asarray(tree["in_proj"]["w"]), np.asarray(
        tree["out"]["w"])
    model = RNNLM(cell, w_in.shape[0], w_in.shape[1], w_out.shape[1])
    with torch.no_grad():
        for lin, name in ((model.in_proj, "in_proj"), (model.out, "out")):
            lin.weight.copy_(arr(tree[name]["w"]).t())
            lin.bias.copy_(arr(tree[name]["b"]))
        for name in ("wx", "wh", "b"):
            getattr(model.cell, name).copy_(arr(tree["cell"][name]))
    return model.to(device)
