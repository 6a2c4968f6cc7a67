"""Mixture-of-experts FFN: shared + routed experts (DeepSeekMoE / OLMoE /
Jamba style) with top-k routing and capacity buffers.

Ported from the JAX package's ``models/moe.py``, both of its paths.  The
reference computes the dispatch and the expert products outside any
Pallas kernel, so the port computes them in plain PyTorch: integer index
ops for the routing and ``torch.bmm`` for the batched expert products.

  * ``dense`` (``moe_impl="dense"``, and any run without a model axis):
    every expert local;
  * ``ep`` (``moe_impl="ep"`` under a mesh whose ``model`` axis splits
    the experts, the reference's ``shard_map`` path): each rank holds
    E / n experts (the reference's ``P("model", None, None)``), routes
    every one of its local tokens through the whole router (the same
    integers on every rank), fills only its own experts' capacity
    buffers, with the capacity of the batch-local token count, and the
    ranks' partial outputs are all-reduced over ``model``.  No token
    crosses ranks (no all-to-all): the activations arrive replicated over
    ``model``.  The shared experts run tensor-parallel over their d_ff
    when it divides the axis, their part summed in the same all-reduce.
    ``aux`` is the same on every model rank; its value is averaged over
    the batch axes (its gradient is each shard's own, which the step's
    gradient mean averages).

Routing (``route``) follows the reference's integer logic exactly: the
softmax router's top-k, ties to the lower expert id (``jax.lax.top_k``'s
order, here a stable descending sort); a routed copy's place in its
expert's queue is the exclusive cumsum over the (T·k) copies in token
order; copies past the capacity C = max(1, ceil(T·k·cf / E)) are dropped
to the sentinel slot E·C.

``dense`` under a data axis (a mesh of D x 1, D > 1, each rank holding
its contiguous rows of the global batch in rank order,
``sharding.local_batch``) routes as the reference routes the global
batch under GSPMD: C is the capacity of the global T (the local T times
D); a copy's queue position is its local exclusive position plus the
copies of its expert in the earlier shards (one all-gather of each
shard's (E,) counts); it is kept if and only if that global position is
below C; and aux is E·Σ_e f_e·P_e over the global batch (the counts and
the probability sums all-reduced).  Each rank's buffer holds only its
own kept copies, at their local positions, min(C, T_local) slots an
expert.  aux's value is the global one; its gradient on each rank is
E·f_e / T_local on the rank's own probabilities, so that the step's
gradient mean over the data axis is the global aux's gradient (the
Megatron pattern of a forward all-reduce with a local backward; the
router and aux stay outside any split region, as in ``ep``).  The
reference's ``ep`` path routes each shard alone (its capacity of the
shard's T, a pmean of aux), and so does the port's.

Token INDICES (not vectors) are scattered into the (E·C + 1,) buffer and
the rows gathered once into the (E, C, D) expert buffer. The combine
differs in form, not in value: where the reference scatter-adds the
expert outputs into (T + 1, D), each token here gathers its k copies by
their slots (dropped copies read a zero row) and sums them in a fixed
order, because a float scatter-add on CUDA takes atomics and its sum
order changes from run to run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
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
    copy (T·k, token order) its queue position ``pos`` (global under a
    data axis), ``keep`` and its buffer ``slot`` (E·``buf`` for a
    dropped copy), ``buf`` the buffer's slots per expert; and the
    load-balance ``aux``, E·Σ_e f_e·P_e."""
    sel: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    aux: torch.Tensor
    buf: int


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of the k largest per row, ties to the lower id."""
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt[..., :k], order[..., :k]


def _router_probs(router: torch.Tensor, x_flat: torch.Tensor):
    logits = (x_flat @ router.to(x_flat.dtype)).float()
    return torch.softmax(logits, dim=-1)


def queue_positions(flat_sel: torch.Tensor, E: int) -> torch.Tensor:
    """Each routed copy's exclusive position in its expert's queue, in
    token order."""
    oh = F.one_hot(flat_sel, E)                               # (T*k, E)
    return (torch.cumsum(oh, 0) - oh).gather(1, flat_sel[:, None])[:, 0]


def offset_positions(local: torch.Tensor, flat_sel: torch.Tensor,
                     counts: list, index: int):
    """(global queue positions, global (E,) counts) of shard ``index``'s
    copies: their ``local`` positions plus the copies of their expert in
    the shards before it; ``counts`` is every shard's (E,) expert counts
    in rank order."""
    zero = torch.zeros_like(counts[0])
    return local + sum(counts[:index], zero)[flat_sel], sum(counts, zero)


def global_routing(dist) -> bool:
    """Whether the dense path routes the global batch: a data axis of
    more than one whose ranks hold split rows."""
    return dist is not None and dist.n_batch > 1 and dist.rows_split


def route(router: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig,
          cap: int | None = None, dist=None) -> Routing:
    """The reference's ``_route_local`` with every expert local: route
    x_flat (T, D) through the softmax router to its top-k experts, each
    holding ``cap`` slots of the routed batch's queue (by default
    ``capacity`` of the routed batch).  Under ``dist``
    (``global_routing``) x_flat is this rank's rows of the routed global
    batch (the module's docstring)."""
    mo = cfg.moe
    T = x_flat.shape[0]
    k, E = mo.top_k, mo.num_experts
    glob = global_routing(dist)
    if cap is None:
        cap = capacity(T * dist.n_batch if glob else T, cfg)
    probs = _router_probs(router, x_flat)                     # (T, E)
    gate, sel = _top_k(probs, k)                              # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_sel = sel.reshape(-1)                                # (T*k,)
    # (not bincount: it syncs on CUDA and has no meta version)
    counts = F.one_hot(flat_sel, E).sum(0)
    local = queue_positions(flat_sel, E)
    if not glob:
        f = counts.float() / (T * k)
        aux = mo.num_experts * (f * probs.mean(0)).sum()
        pos, buf = local, cap
    else:
        n = dist.n_batch
        pos, total = offset_positions(
            local, flat_sel, collectives.all_gather(counts, dist, "batch"),
            dist.batch_index)
        f = total.float() / (T * n * k)
        p_sum = collectives.all_reduce_sum(probs.sum(0), dist, "batch")
        mine = mo.num_experts * (f * probs.mean(0)).sum()
        aux = mine + (mo.num_experts * (f * p_sum / (T * n)).sum()
                      - mine).detach()
        # a kept copy's local position is below its global one and below
        # T (a token picks an expert once)
        buf = min(cap, T)
    keep = pos < cap
    slot = torch.where(keep, flat_sel * buf + local,
                       torch.full_like(pos, E * buf))
    return Routing(sel, gate, pos, keep, slot, aux, buf)


def _experts(p: MoE, x_buf: torch.Tensor) -> torch.Tensor:
    """(E, C, D) buffer -> (E, C, D): each expert's SwiGLU on its rows."""
    dt = x_buf.dtype
    g = torch.bmm(x_buf, p.w_gate.to(dt))
    u = torch.bmm(x_buf, p.w_up.to(dt))
    return torch.bmm(F.silu(g) * u, p.w_down.to(dt))


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, dist=None):
    """MoE FFN. x: (B, S, D), this rank's batch rows under ``dist``.
    Returns (y (B, S, D), aux scalar f32).  Under ``dist`` with a model
    axis of more than one, ``moe_impl="ep"`` runs the expert-parallel
    path (``p`` holding the rank's experts); ``"dense"`` keeps every
    expert on the rank and so takes no model axis."""
    if dist is not None and dist.n_model > 1:
        if cfg.moe_impl != "ep":
            raise ValueError(
                f"moe_impl={cfg.moe_impl!r} keeps every expert on the rank; "
                f"a model axis of {dist.n_model} needs moe_impl='ep'")
        return _moe_ep(p, x, cfg, dist)
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    T, dt = x_flat.shape[0], x_flat.dtype
    mo = cfg.moe
    k, E = mo.top_k, mo.num_experts
    r = route(p.router, x_flat, cfg, dist=dist)
    C = r.buf

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


def _moe_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig, dist):
    """The expert-parallel path (the module's docstring)."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    T, dt = x_flat.shape[0], x_flat.dtype
    mo = cfg.moe
    k, n_local = mo.top_k, p.w_gate.shape[0]
    if n_local * dist.n_model != mo.num_experts:
        raise ValueError(f"experts {mo.num_experts} must divide the model "
                         f"axis {dist.n_model}")
    C, off = capacity(T, cfg), dist.model_index * n_local
    # routing: the same on every rank, outside the split region (its
    # gradient, and aux's, are whole on each rank)
    r = route(p.router, x_flat, cfg, C)
    flat_sel = r.sel.reshape(-1)
    local = (flat_sel >= off) & (flat_sel < off + n_local)
    keep = r.keep & local
    slot = torch.where(keep, (flat_sel - off) * C + r.pos,
                       torch.full_like(r.pos, n_local * C))
    # the split region: each rank's experts see the tokens and gates,
    # whose gradients are summed over the axis
    xr = collectives.copy_to_model(x_flat, dist)
    gate = collectives.copy_to_model(r.gate, dist)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    idx_buf = torch.full((n_local * C + 1,), T, dtype=tok.dtype,
                         device=x.device)
    idx_buf = idx_buf.scatter(0, slot, tok)[:-1]
    x_pad = torch.cat([xr, xr.new_zeros(1, D)])
    y_buf = _experts(p, x_pad[idx_buf].reshape(n_local, C, D))
    y_pad = torch.cat([y_buf.reshape(n_local * C, D), y_buf.new_zeros(1, D)])
    g = torch.where(keep, gate.reshape(-1), 0.0).to(dt)
    part = (y_pad[slot] * g[:, None]).reshape(T, k, D).sum(1)
    shared_whole = None
    if mo.num_shared:
        if p.shared.w_gate.shape[1] == mo.num_shared * mo.d_ff_expert:
            shared_whole = p.shared(x_flat)
        else:
            part = part + p.shared(xr)
    out = collectives.reduce_from_model(part, dist)
    if shared_whole is not None:
        out = out + shared_whole
    aux = r.aux
    if dist.n_batch > 1:
        mean = collectives.all_reduce_sum(aux, dist, "batch") / dist.n_batch
        aux = aux + (mean - aux).detach()
    return out.reshape(B, S, D), aux


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
