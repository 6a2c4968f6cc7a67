"""Self-built optimizer substrate, in the optax style of the JAX package's
``optim/optimizers.py``.

Each transform is an (init, update) pair over a flat dict of tensors
``{name: tensor}``; ``chain`` composes, ``apply_updates`` adds.  The order
of operations is the reference's, so a step on the same gradients gives
the same update within f32 rounding.  It holds every optimizer the paper
uses and every name ``make_optimizer`` (and so a ``TrainConfig``) takes:
``adam``, ``adamw``, ``adafactor`` (factored second moment, bf16 first
moment), ``adagrad``, ``rmsprop`` and ``sgd`` (with ``momentum``: a
trace), with global-norm clipping, bf16 gradient compression, decoupled
weight decay, and the warmup-cosine and constant schedules.  A state is
a nest of dicts keyed as the reference's, with one tensor per param name
at the leaves, so it checkpoints through ``checkpoint/checkpointer.py``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple]   # (grads, state, params)


def _map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _count(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree, sharded=(), all_reduce=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  On a rank of a mesh: the names
    in ``sharded`` are this rank's shards of leaves split over the model
    axis, whose squares ``all_reduce`` sums over that axis; every other
    leaf is whole on each rank and counted once."""
    def sq(names):
        return sum(torch.sum(torch.square(tree[n].float())) for n in names)

    if not sharded:
        return torch.sqrt(sq(tree))
    split = sq(n for n in tree if n in sharded)
    return torch.sqrt(sq(n for n in tree if n not in sharded)
                      + all_reduce(split))


# --------------------------------------------------------------------------
# Basic transforms
# --------------------------------------------------------------------------

def clip_by_global_norm(max_norm: float, norm_fn=None) -> Transform:
    """Scale the gradients so that ``norm_fn(grads)`` (``global_norm`` by
    default; a mesh's ``global_norm`` over shards in the parallel step)
    is at most ``max_norm``."""
    def update(grads, state, params):
        norm = (norm_fn or global_norm)(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return _map(lambda g: g * scale, grads), state

    return Transform(lambda p: (), update)


def scale(factor: float) -> Transform:
    return Transform(lambda p: (),
                     lambda g, s, p: (_map(lambda x: x * factor, g), s))


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Transform:
    def update(grads, count, params):
        lr = schedule(count)
        return _map(lambda g: g * lr, grads), count + 1

    return Transform(_count, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params):
        return _map(lambda g, p: g + weight_decay * p.to(g.dtype),
                    grads, params), state

    return Transform(lambda p: (), update)


def compress_gradients(mode: str = "bf16") -> Transform:
    """Gradient compression: cast to bf16 and back.  'none' is a no-op."""
    def update(grads, state, params):
        if mode == "none":
            return grads, state
        return _map(lambda g: g.to(torch.bfloat16).float(), grads), state

    return Transform(lambda p: (), update)


# --------------------------------------------------------------------------
# Second-moment optimizers
# --------------------------------------------------------------------------

def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def init(params):
        def zeros():
            return _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        return {"mu": zeros(), "nu": zeros(), "count": _count(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                  state["nu"], grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        upd = _map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                   mu, nu)
        return upd, {"mu": mu, "nu": nu, "count": count}

    return Transform(init, update)


def scale_by_adafactor(b1: float = 0.9, decay: float = 0.999,
                       eps: float = 1e-30,
                       momentum_dtype=torch.bfloat16) -> Transform:
    """Adafactor-style: a factored second moment for params of ndim >= 2
    (running means over the last axis and over the one before it instead
    of a full tensor) and a first moment stored in ``momentum_dtype``.
    State ``{"s": {name: {"mu": ..., "nu": {"vr", "vc"} or {"v"}}},
    "count"}``, as the reference's."""

    def init(params):
        def one(p):
            if p.ndim >= 2:
                nu = {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                        device=p.device),
                      "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                        dtype=torch.float32,
                                        device=p.device)}
            else:
                nu = {"v": torch.zeros_like(p, dtype=torch.float32)}
            return {"mu": torch.zeros_like(p, dtype=momentum_dtype),
                    "nu": nu}
        return {"s": _map(one, params), "count": _count(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        c2 = 1 - decay ** count.float()

        def one(g, st):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.ndim >= 2:
                vr = decay * st["nu"]["vr"] + (1 - decay) * g2.mean(-1)
                vc = decay * st["nu"]["vc"] + (1 - decay) * g2.mean(-2)
                denom_sq = (vr[..., None] * vc[..., None, :]
                            / torch.clamp(vr.mean(-1)[..., None, None],
                                          min=1e-30)) / c2
                nu = {"vr": vr, "vc": vc}
            else:
                v = decay * st["nu"]["v"] + (1 - decay) * g2
                denom_sq = v / c2
                nu = {"v": v}
            upd = g32 / (torch.sqrt(denom_sq) + 1e-8)
            mu = b1 * st["mu"].float() + (1 - b1) * upd
            return mu, {"mu": mu.to(momentum_dtype), "nu": nu}

        outs = {k: one(grads[k], state["s"][k]) for k in grads}
        return ({k: o[0] for k, o in outs.items()},
                {"s": {k: o[1] for k, o in outs.items()}, "count": count})

    return Transform(init, update)


def _zeros_f32(params: Tree) -> Tree:
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def scale_by_adagrad(eps: float = 1e-8) -> Transform:
    def update(grads, acc, params):
        acc = _map(lambda a, g: a + torch.square(g), acc, grads)
        upd = _map(lambda g, a: g / (torch.sqrt(a) + eps), grads, acc)
        return upd, acc

    return Transform(_zeros_f32, update)


def scale_by_rmsprop(decay: float = 0.9, eps: float = 1e-8) -> Transform:
    def update(grads, nu, params):
        nu = _map(lambda v, g: decay * v + (1 - decay) * torch.square(g),
                  nu, grads)
        upd = _map(lambda g, v: g / (torch.sqrt(v) + eps), grads, nu)
        return upd, nu

    return Transform(_zeros_f32, update)


def trace_momentum(momentum: float) -> Transform:
    def update(grads, tr, params):
        tr = _map(lambda t, g: momentum * t + g, tr, grads)
        return tr, tr

    return Transform(_zeros_f32, update)


# --------------------------------------------------------------------------
# Schedules + named constructor
# --------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def schedule(count):
        c = count.float()
        warm = c / max(warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return base_lr * torch.where(c < warmup_steps, warm, cos)

    return schedule


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32,
                                      device=count.device)


def make_optimizer(name: str, lr, *, b1=0.9, b2=0.999, eps=1e-8,
                   momentum=0.0, weight_decay=0.0, grad_clip_norm=0.0,
                   compression: str = "none",
                   norm_fn=None) -> Transform:
    """Named constructor used by TrainConfig.

    lr: float or schedule callable.  Returned updates are ready for
    apply_updates (they already include the negative sign).  ``norm_fn``
    is the clipping's global norm.
    """
    parts = []
    if grad_clip_norm and grad_clip_norm > 0:
        parts.append(clip_by_global_norm(grad_clip_norm, norm_fn))
    if compression != "none":
        parts.append(compress_gradients(compression))
    if name in ("adam", "adamw"):
        parts.append(scale_by_adam(b1, b2, eps))
        if name == "adamw" and weight_decay:
            parts.append(add_decayed_weights(weight_decay))
    elif name == "adafactor":
        parts.append(scale_by_adafactor(b1, b2, eps))
        if weight_decay:
            parts.append(add_decayed_weights(weight_decay))
    elif name == "adagrad":
        parts.append(scale_by_adagrad(eps))
    elif name == "rmsprop":
        parts.append(scale_by_rmsprop(decay=0.9, eps=eps))
    elif name == "sgd":
        if momentum:
            parts.append(trace_momentum(momentum))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    sched = lr if callable(lr) else constant(lr)
    parts.append(scale_by_schedule(lambda c: -sched(c)))
    return chain(*parts)
