"""Shared benchmark engine of the paper's benches: train one (task x
IOEmbedding) combination and report (score, train_time, eval_time) — the
measurement behind every paper figure and table reproduction.

The JAX package's ``benchmarks/common.py`` in PyTorch, on ``device``
(CUDA unless the caller asks for the CPU).  Baseline (S_0) = identity
encoding (m == d, k == 1 -> exact one-hot space), matching the paper's
plain-network baseline; the benches report scores as ratios S_i/S_0 like
the paper.  A Bloom embedding's evaluation ranks all d items with Eq. 3
(``core.alternatives.eq3_scores``): on the card, the ``bloom_decode``
kernel.

Timing follows the reference: one warm-up step and one warm evaluation
stay outside the timed windows; the train window ends with the card
synchronised (the reference's ``block_until_ready``), the eval window
includes copying the scores to the host.  The data seed is the
reference's ``hash(name) % 2**31``: Python salts str hashes per process,
so both packages build the same data inside one process, and a run is
reproducible only with ``PYTHONHASHSEED`` pinned (``PYTHONHASHSEED=0``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.paper_tasks import PAPER_TASKS, PaperTask
from repro_torch.core import losses
from repro_torch.core.alternatives import BloomIO, IOEmbedding
from repro_torch.data import synthetic
from repro_torch.data.pipeline import BatchIterator
from repro_torch.kernels.common import resolve_device
from repro_torch.models import recommender as rec
from repro_torch.models import rnn
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import metrics as M
from repro_torch.train.trainer import apply_gradients


@functools.lru_cache(maxsize=None)
def task_data(name: str, scale: float = 1.0):
    t = PAPER_TASKS[name]
    n = max(int(t.n * scale), 300)
    if t.kind == "recsys":
        return synthetic.make_recsys(n=n, d=t.d, mean_items=t.mean_items,
                                     seed=hash(name) % 2**31)
    if t.kind == "classify":
        return synthetic.make_classification(
            n=n, d=t.d, n_classes=t.n_classes, mean_items=t.mean_items,
            seed=hash(name) % 2**31)
    return synthetic.make_sessions(n_sessions=n, d=t.d,
                                   mean_len=t.mean_items,
                                   seed=hash(name) % 2**31)


def baseline_embedding(d: int, device=None) -> BloomIO:
    """Identity encoding: the paper's no-embedding Baseline."""
    return BloomIO.build(d=d, m=d, k=1, name="Baseline", device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def bench_step(model, tx, loss_fn):
    """The reference's bench step: ``step(opt_state, batch) -> opt_state``
    takes the gradients of ``loss_fn(model, batch)`` (a scalar), runs the
    optimizer and applies its update to the model's params in place, and
    computes nothing else (no metrics, no gradient norm beyond the
    optimizer's own clipping), so the timed window holds the reference's
    work and no more."""
    params = dict(model.named_parameters())

    def step(opt_state, batch):
        grads = torch.autograd.grad(loss_fn(model, batch),
                                    list(params.values()))
        return apply_gradients(params, dict(zip(params, grads)), tx,
                               opt_state)

    return step


def _train(model, tx, loss_fn, it: BatchIterator, steps: int,
           device: torch.device) -> float:
    """One untimed warm-up step, then ``steps`` timed steps of
    ``bench_step`` over ``it``'s batches; ``loss_fn(model, batch)`` returns
    the scalar loss.  Returns the seconds of the timed steps."""
    step = bench_step(model, tx, loss_fn)
    opt_state = tx.init(dict(model.named_parameters()))

    def one():
        nonlocal opt_state
        batch = tuple(torch.as_tensor(a, device=device) for a in next(it))
        opt_state = step(opt_state, batch)

    one()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    _sync(device)
    return time.perf_counter() - t0


def _evaluate(fn, args, device: torch.device):
    """``fn`` on ``args`` (numpy, moved to ``device``) once warm, then once
    timed up to its result on the host; returns (numpy result, seconds)."""
    def call():
        with torch.no_grad():
            return fn(*(torch.as_tensor(a, device=device)
                        for a in args)).cpu().numpy()

    call()
    _sync(device)
    t0 = time.perf_counter()
    out = call()
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------
# Feed-forward recommender tasks (ML / MSD / AMZ / BC)
# --------------------------------------------------------------------------

def run_recsys(task: PaperTask, emb: IOEmbedding, steps: int = 120,
               seed: int = 0, scale: float = 1.0,
               device=None) -> Dict[str, float]:
    device = resolve_device(device)
    data = task_data(task.name, scale)
    model = rec.recommender_init(emb, list(task.arch_hidden),
                                 generator=_generator(seed), device=device)
    tx = opt_lib.make_optimizer(task.optimizer, task.learning_rate,
                                momentum=task.momentum,
                                grad_clip_norm=task.grad_clip)
    train_time = _train(
        model, tx, lambda mdl, b: rec.recommender_loss(mdl, emb, *b),
        BatchIterator(list(data.train()), task.batch, seed=seed), steps,
        device)

    p_te, q_te = data.test()
    scores, eval_time = _evaluate(
        lambda p: rec.recommender_scores(model, emb, p), (p_te,), device)
    return {"score": M.mean_average_precision(scores, q_te, p_te),
            "train_time": train_time, "eval_time": eval_time}


# --------------------------------------------------------------------------
# Classification task (CADE): input embedding only
# --------------------------------------------------------------------------

def run_classify(task: PaperTask, emb: IOEmbedding, steps: int = 120,
                 seed: int = 0, scale: float = 1.0,
                 device=None) -> Dict[str, float]:
    device = resolve_device(device)
    p_all, labels, n_train, _ = task_data(task.name, scale)
    model = rec.ff_init(emb.m_in, list(task.arch_hidden), task.n_classes,
                        generator=_generator(seed), device=device)
    tx = opt_lib.make_optimizer(task.optimizer, task.learning_rate)

    def loss(mdl, batch):
        p, y = batch
        logits = mdl(emb.encode_input(p))
        return losses.softmax_xent_label(logits, y).mean()

    train_time = _train(
        model, tx, loss,
        BatchIterator([p_all[:n_train], labels[:n_train]], task.batch,
                      seed=seed), steps, device)

    p_te, y_te = p_all[n_train:], labels[n_train:]
    logits, eval_time = _evaluate(
        lambda p: model(emb.encode_input(p)), (p_te,), device)
    return {"score": M.accuracy(logits, y_te),
            "train_time": train_time, "eval_time": eval_time}


# --------------------------------------------------------------------------
# Session tasks (YC GRU / PTB LSTM): next-item prediction
# --------------------------------------------------------------------------

def session_test(seqs: np.ndarray, n_train: int):
    """The session eval set: test sequences of at least two items, each
    cut before its last item.  Returns (ctx (B, T) -1-padded, tgt (B,) the
    cut item, idx (B,) the position whose output predicts it)."""
    test = seqs[n_train:]
    lengths = (test >= 0).sum(1)
    keep = lengths >= 2
    test, lengths = test[keep], lengths[keep]
    ctx = test.copy()
    tgt = np.zeros(len(test), np.int64)
    for i, L in enumerate(lengths):
        tgt[i] = test[i, L - 1]
        ctx[i, L - 1:] = -1
    return ctx, tgt, lengths - 2


def run_session(task: PaperTask, emb: IOEmbedding, steps: int = 120,
                seed: int = 0, scale: float = 1.0,
                device=None) -> Dict[str, float]:
    device = resolve_device(device)
    seqs, n_train = task_data(task.name, scale)
    d_h = task.arch_hidden[0]
    model = rnn.rnn_lm_init(task.cell, emb.m_in, d_h, emb.m_out,
                            generator=_generator(seed), device=device)
    tx = opt_lib.make_optimizer(task.optimizer, task.learning_rate,
                                momentum=task.momentum,
                                grad_clip_norm=task.grad_clip)

    def encode_seq(s):
        # (B, T) item ids -> (B, T, m_in); -1 padded positions are zeros
        return emb.encode_input(s[..., None])

    def loss(mdl, batch):
        (s,) = batch
        x_in, tgt = s[:, :-1], s[:, 1:]
        valid = (tgt >= 0) & (x_in >= 0)
        logits = rnn.rnn_lm_apply(mdl, task.cell, encode_seq(x_in))
        B, T, mo = logits.shape
        per = emb.loss(logits.reshape(B * T, mo), tgt.reshape(B * T, 1))
        return (per * valid.reshape(-1)).sum() / torch.clamp(
            valid.sum(), min=1)

    train_time = _train(model, tx, loss,
                        BatchIterator([seqs[:n_train]], task.batch,
                                      seed=seed), steps, device)

    # eval: RR of the true next item after the penultimate position
    ctx, tgt, idx = session_test(seqs, n_train)

    def score_last(s, i):
        hs = rnn.rnn_lm_apply(model, task.cell, encode_seq(s))
        last = hs[torch.arange(hs.shape[0], device=hs.device), i.long()]
        return emb.decode(last)

    scores, eval_time = _evaluate(score_last, (ctx, idx), device)
    return {"score": M.reciprocal_rank(scores, tgt),
            "train_time": train_time, "eval_time": eval_time}


RUNNERS: Dict[str, Callable] = {
    "recsys": run_recsys,
    "classify": run_classify,
    "session": run_session,
}


def run_task(name: str, emb: IOEmbedding, steps: int = 120, seed: int = 0,
             scale: float = 1.0, device=None) -> Dict[str, float]:
    task = PAPER_TASKS[name]
    return RUNNERS[task.kind](task, emb, steps=steps, seed=seed,
                              scale=scale, device=device)
