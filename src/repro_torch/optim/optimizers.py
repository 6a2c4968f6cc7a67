"""Self-built optimizer substrate, in the optax style of the JAX package's
``optim/optimizers.py``.

Each transform is an (init, update) pair over a flat dict of tensors
``{name: tensor}``; ``chain`` composes, ``apply_updates`` adds.  The order
of operations is the reference's, so a step on the same gradients gives
the same update within f32 rounding.  Ported: what ``make_optimizer``
reaches for ``adam`` and ``adamw`` (global-norm clipping, bf16 gradient
compression, Adam, decoupled weight decay, the warmup-cosine and constant
schedules).  Adafactor, Adagrad, RMSprop and SGD raise (ROADMAP A6).
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


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


# --------------------------------------------------------------------------
# Basic transforms
# --------------------------------------------------------------------------

def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return _map(lambda g: g * scale, grads), state

    return Transform(lambda p: (), update)


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
# Adam
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
                   compression: str = "none") -> Transform:
    """Named constructor used by TrainConfig.

    lr: float or schedule callable.  Returned updates are ready for
    apply_updates (they already include the negative sign).
    """
    if name not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A6); ported: "
            "adam, adamw")
    parts = []
    if grad_clip_norm and grad_clip_norm > 0:
        parts.append(clip_by_global_norm(grad_clip_norm))
    if compression != "none":
        parts.append(compress_gradients(compression))
    parts.append(scale_by_adam(b1, b2, eps))
    if name == "adamw" and weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    sched = lr if callable(lr) else constant(lr)
    parts.append(scale_by_schedule(lambda c: -sched(c)))
    return chain(*parts)
