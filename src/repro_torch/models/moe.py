"""Mixture-of-experts FFN: shared + routed experts (DeepSeekMoE / OLMoE /
Jamba style) with top-k routing and capacity buffers.

Ported from the JAX package's ``models/moe.py``, its single-device path
(the one it takes whenever it runs without a mesh): every expert is
local.  The reference computes the dispatch and the expert products
outside any Pallas kernel, so the port computes them in plain PyTorch:
integer index ops for the routing and ``torch.bmm`` for the batched
expert products.  Its expert-parallel path waits for ROADMAP A13.

Routing (``route``) follows the reference's integer logic exactly: the
softmax router's top-k, ties to the lower expert id (``jax.lax.top_k``'s
order, here a stable descending sort); a routed copy's place in its
expert's queue is the exclusive cumsum over the (T·k) copies in token
order; copies past the capacity C = max(1, ceil(T·k·cf / E)) are dropped
to the sentinel slot E·C.  Token INDICES (not vectors) are scattered
into the (E·C + 1,) buffer and the rows gathered once into the (E, C, D)
expert buffer.  The combine differs in form, not in value: where the
reference scatter-adds the expert outputs into (T + 1, D), each token
here gathers its k copies by their slots (dropped copies read a zero
row) and sums them in a fixed order, because a float scatter-add on
CUDA takes atomics and its sum order changes from run to run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class MoE(nn.Module):
    """One MoE FFN's weights in the reference's layout: ``router`` (D, E),
    ``w_gate`` / ``w_up`` (E, D, Fe), ``w_down`` (E, Fe, D), and
    ``shared`` (a SwiGLU of num_shared * Fe) when there are shared experts.
    The reference draws the expert weights as (E·D, Fe) and (E·Fe, D)
    and reshapes, so their fan-in, and std, is E·D and E·Fe."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mo = cfg.moe
        D, Fe, E = cfg.d_model, mo.d_ff_expert, mo.num_experts
        tn = layers.truncated_normal
        self.router = nn.Parameter(tn((D, E), 1.0, generator))
        self.w_gate = nn.Parameter(
            tn((E * D, Fe), 1.0, generator).reshape(E, D, Fe))
        self.w_up = nn.Parameter(
            tn((E * D, Fe), 1.0, generator).reshape(E, D, Fe))
        self.w_down = nn.Parameter(
            tn((E * Fe, D), 1.0, generator).reshape(E, Fe, D))
        if mo.num_shared:
            self.shared = layers.SwiGLU(D, mo.num_shared * Fe, generator)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: max(1, ceil(T·k·cf / E))."""
    mo = cfg.moe
    return max(1, math.ceil(tokens * mo.top_k * mo.capacity_factor
                            / mo.num_experts))


@dataclasses.dataclass
class Routing:
    """One routing of T tokens: ``sel`` (T, k) expert ids and ``gate``
    (T, k) f32 renormalised weights, each row's best first; per routed
    copy (T·k, token order) its queue position ``pos``, ``keep`` and its
    buffer ``slot`` (E·C for a dropped copy); and the load-balance
    ``aux``, E·Σ_e f_e·P_e."""
    sel: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    aux: torch.Tensor


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of the k largest per row, ties to the lower id."""
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt[..., :k], order[..., :k]


def _router_probs(router: torch.Tensor, x_flat: torch.Tensor):
    logits = (x_flat @ router.to(x_flat.dtype)).float()
    return torch.softmax(logits, dim=-1)


def route(router: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig,
          cap: int) -> Routing:
    """The reference's ``_route_local`` with every expert local: route
    x_flat (T, D) through the softmax router to its top-k experts, each
    holding ``cap`` slots."""
    mo = cfg.moe
    T = x_flat.shape[0]
    k, E = mo.top_k, mo.num_experts
    probs = _router_probs(router, x_flat)                     # (T, E)
    gate, sel = _top_k(probs, k)                              # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_sel = sel.reshape(-1)                                # (T*k,)
    f = torch.bincount(flat_sel, minlength=E).float() / (T * k)
    aux = mo.num_experts * (f * probs.mean(0)).sum()

    # position of each routed copy within its expert's queue (exclusive)
    oh = F.one_hot(flat_sel, E)                               # (T*k, E)
    pos = (torch.cumsum(oh, 0) - oh).gather(1, flat_sel[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, flat_sel * cap + pos,
                       torch.full_like(pos, E * cap))
    return Routing(sel, gate, pos, keep, slot, aux)


def _experts(p: MoE, x_buf: torch.Tensor) -> torch.Tensor:
    """(E, C, D) buffer -> (E, C, D): each expert's SwiGLU on its rows."""
    dt = x_buf.dtype
    g = torch.bmm(x_buf, p.w_gate.to(dt))
    u = torch.bmm(x_buf, p.w_up.to(dt))
    return torch.bmm(F.silu(g) * u, p.w_down.to(dt))


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, dist=None):
    """MoE FFN. x: (B, S, D). Returns (y (B, S, D), aux scalar f32).
    ``dist`` (a mesh context, the reference's expert-parallel path) is
    not ported (ROADMAP A13)."""
    if dist is not None:
        raise NotImplementedError(
            "the expert-parallel MoE path is not ported yet (ROADMAP A13)")
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    T, dt = x_flat.shape[0], x_flat.dtype
    mo = cfg.moe
    k, E, C = mo.top_k, mo.num_experts, capacity(T, cfg)
    r = route(p.router, x_flat, cfg, C)

    # scatter token indices (not vectors) into the buffer, then gather
    # once; dropped copies all land on the sentinel slot E*C, cut off
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    idx_buf = torch.full((E * C + 1,), T, dtype=tok.dtype, device=x.device)
    idx_buf = idx_buf.scatter(0, r.slot, tok)[:-1]
    x_pad = torch.cat([x_flat, x_flat.new_zeros(1, D)])
    y_buf = _experts(p, x_pad[idx_buf].reshape(E, C, D))

    # combine: each copy reads its slot's row (zero for a dropped copy)
    # times its gate; a token's k copies are summed in a fixed order
    y_pad = torch.cat([y_buf.reshape(E * C, D), y_buf.new_zeros(1, D)])
    gate = torch.where(r.keep, r.gate.reshape(-1), 0.0).to(dt)
    out = (y_pad[r.slot] * gate[:, None]).reshape(T, k, D).sum(1)
    if mo.num_shared:
        out = out + p.shared(x_flat)
    return out.reshape(B, S, D), r.aux


def moe_apply_reference(p: MoE, x: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Oracle: every expert computed densely for every token (O(E) FLOPs),
    weighted by the same top-k gates and no capacity; tokens none of whose
    copies the capacity path dropped must match it."""
    B, S, D = x.shape
    mo = cfg.moe
    x_flat = x.reshape(B * S, D)
    dt = x_flat.dtype
    gate, sel = _top_k(_router_probs(p.router, x_flat), mo.top_k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    g = torch.einsum("td,edf->tef", x_flat, p.w_gate.to(dt))
    u = torch.einsum("td,edf->tef", x_flat, p.w_up.to(dt))
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, p.w_down.to(dt))
    mask = F.one_hot(sel, mo.num_experts).float()             # (T, k, E)
    w = (mask * gate[..., None]).sum(1)                       # (T, E)
    out = torch.einsum("ted,te->td", y, w.to(dt))
    if mo.num_shared:
        out = out + p.shared(x_flat)
    return out.reshape(B, S, D)
