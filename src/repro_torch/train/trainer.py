"""Training loop substrate: TrainState, the train step, the fault-tolerant
loop, and the optimizer a TrainConfig names (the JAX package's
``train/trainer.py``).

A model is an ``nn.Module`` whose parameters the step updates in place;
a loss is ``loss_fn(model, batch) -> (scalar, metrics)``, differentiated
by autograd.  The loop is restart-oriented: every ``checkpoint_every``
steps the full state (params, optimizer state, step, data cursor and the
logged history) is saved atomically, and ``Trainer.run`` always begins by
trying a restore, so a crash, a preemption or an induced fault
(``train_fault@S``) resumes exactly where it left off.  The LM trains
through ``launch/train.py``, whose step casts to the compute dtype.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import optimizers as opt_lib


@dataclasses.dataclass
class TrainState:
    params: nn.Module       # the model; its parameters change in place
    opt_state: Any
    step: int


def make_optimizer(tc: TrainConfig, total_steps: Optional[int] = None):
    sched = (opt_lib.warmup_cosine(tc.learning_rate, tc.warmup_steps,
                                   total_steps or tc.steps)
             if tc.warmup_steps else tc.learning_rate)
    return opt_lib.make_optimizer(
        tc.optimizer, sched, b1=tc.beta1, b2=tc.beta2, eps=tc.eps,
        momentum=tc.momentum, weight_decay=tc.weight_decay,
        grad_clip_norm=tc.grad_clip_norm, compression=tc.grad_compression)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def make_train_step(loss_fn: Callable, optimizer, microbatch: int = 0):
    """``step(model, opt_state, batch) -> (opt_state, metrics)``.

    ``loss_fn(model, batch) -> (scalar, metrics dict)``.  The step takes
    the gradients by autograd, runs the optimizer and writes
    ``(p + u).to(p.dtype)`` into the model's parameters.  With
    ``microbatch > 1`` the batch's leading axis is split into that many
    equal chunks: the gradients are summed into f32 and divided by the
    chunk count, and the loss and every metric are averaged over the
    chunks (equal chunks, so the mean of the chunk means is the full
    batch's mean, as with ``microbatch`` 1).  The metrics add ``loss`` and
    ``grad_norm`` (the global norm of the gradients the optimizer gets).
    """

    def grads_of(model, params, batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if microbatch and microbatch > 1:
            def split(x):
                b = x.shape[0]
                assert b % microbatch == 0, (b, microbatch)
                return x.reshape(microbatch, b // microbatch, *x.shape[1:])

            micro = _tree_map(split, batch)
            g = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            chunk_metrics = []
            for i in range(microbatch):
                mb = _tree_map(lambda x: x[i], micro)
                li, mi, gi = grads_of(model, params, mb)
                g = {n: g[n] + gi[n] for n in g}
                loss = loss + li
                chunk_metrics.append(mi)
            g = {n: x / microbatch for n, x in g.items()}
            loss = loss / microbatch
            metrics = {k: torch.stack([m[k] for m in chunk_metrics]).mean(0)
                       for k in chunk_metrics[0]}
        else:
            loss, metrics, g = grads_of(model, params, batch)
        detached = {n: p.detach() for n, p in params.items()}
        updates, opt_state = optimizer.update(g, opt_state, detached)
        new = opt_lib.apply_updates(detached, updates)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(new[n])
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = opt_lib.global_norm(g)
        return opt_state, metrics

    return step


class Trainer:
    """Fault-tolerant train loop over a resumable BatchIterator.

    ``init_params`` is the model to train (updated in place);
    ``make_batch`` turns the iterator's numpy arrays into the loss's batch
    (on the model's device).  Train faults come from ``fault_hook`` or from
    ``failpoints`` (a ``serving/failpoints.FailPlan`` or its spec string:
    one grammar for train and serve chaos).
    """

    def __init__(self, loss_fn, init_params: nn.Module, tc: TrainConfig,
                 data_iter, checkpoint_dir: Optional[str] = None,
                 make_batch=None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 failpoints=None):
        self.tc = tc
        self.optimizer = make_optimizer(tc)
        self.loss_fn = loss_fn
        self.data_iter = data_iter
        self.make_batch = make_batch or (lambda arrays: arrays)
        if fault_hook is None and failpoints is not None:
            from repro_torch.serving.failpoints import FailPlan
            plan = (failpoints if isinstance(failpoints, FailPlan)
                    else FailPlan.parse(failpoints))
            fault_hook = plan.train_hook()
        self.fault_hook = fault_hook
        self.step_fn = make_train_step(loss_fn, self.optimizer,
                                       tc.microbatch)
        self.state = TrainState(
            init_params,
            self.optimizer.init(dict(init_params.named_parameters())), 0)
        self.ckpt = (Checkpointer(checkpoint_dir, keep=tc.keep_checkpoints)
                     if checkpoint_dir else None)
        self.history = []

    def _tree(self):
        return {"params": dict(self.state.params.named_parameters()),
                "opt_state": self.state.opt_state}

    # ------------------------------------------------------------------
    def try_restore(self) -> bool:
        if self.ckpt is None:
            return False
        restored, step, extra = self.ckpt.restore_latest(self._tree())
        if restored is None:
            return False
        with torch.no_grad():
            for n, p in self.state.params.named_parameters():
                p.copy_(restored["params"][n])
        self.state = TrainState(self.state.params, restored["opt_state"],
                                step)
        if "data" in extra and hasattr(self.data_iter, "restore"):
            self.data_iter.restore(extra["data"])
        # the history rides in `extra`, so a resumed run returns the whole
        # curve, not only the part after the crash
        if "history" in extra:
            self.history = list(extra["history"])
        return True

    def save(self):
        if self.ckpt is None:
            return
        extra = {"history": list(self.history)}
        if hasattr(self.data_iter, "state"):
            extra["data"] = self.data_iter.state()
        self.ckpt.save(self.state.step, self._tree(), extra=extra)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None, log_every: int = 0):
        steps = steps or self.tc.steps
        self.try_restore()
        t0 = time.perf_counter()
        while self.state.step < steps:
            if self.fault_hook is not None:
                self.fault_hook(self.state.step)   # may raise (drills)
            batch = self.make_batch(next(self.data_iter))
            opt_state, metrics = self.step_fn(self.state.params,
                                              self.state.opt_state, batch)
            self.state = TrainState(self.state.params, opt_state,
                                    self.state.step + 1)
            if log_every and self.state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": self.state.step, **m})
            if (self.tc.checkpoint_every
                    and self.state.step % self.tc.checkpoint_every == 0):
                self.save()
        self.save()
        wall = time.perf_counter() - t0
        return {"steps": self.state.step, "wall_time_s": wall,
                "history": self.history}
