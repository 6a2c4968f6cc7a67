"""The paper benches at their full budget, with their checks.

``chip_smoke.py`` phase ``paper`` runs this on the card; on the CPU,

    PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.benchmarks.paper_phase --device cpu

runs the same points and prints each run's margin over chance (the
"learns" gate's margin).  At ``run.py``'s full budget (``STEPS`` 150,
``SCALE`` 0.6) and the ``PAPER_TASKS`` widths, never cut, it runs:
Fig. 1 on MSD (every m/d), Fig. 2 on MSD (k = 1, 2, 4, 8, 16), Fig. 3 on
MSD, Table 3 at (MSD, 0.1) and (YC, 0.1) (the GRU, every alternative),
Table 5 at (MSD, 0.1) (CBE), counting Bloom on MSD at m/d 0.1, and PTB
(LSTM, sgd) and CADE (classify, rmsprop) at Baseline and at BE k = 4,
m/d 0.2.  It prints the CSV rows (``run.py``'s names; ``tasks.<task>``
and ``counting.MSD`` for the last two) and one line per trained run, and
``check`` holds every run to:

1. the Eq. 3 route: a Bloom-style embedding's evaluated scores (the warm
   and the timed evaluation's) equal ``core.bloom.decode_scores`` on the
   same logits and device, bit for bit;
2. launches: a Bloom-style embedding on a recsys or session task is
   evaluated twice (warm and timed; CADE decodes nothing), and on the
   card each evaluation launched the ``bloom_decode`` kernel once and no
   other counted kernel ran; on the CPU none ran;
3. range: finite, MAP and RR in [0, 1], accuracy in [0, 100];
4. learns: the score is at least ``GATE`` times ``chance_score``, the
   same metric on seeded uniform random scores over the same test set.

Each trained run is recorded by wrapping ``common.RUNNERS`` for the
phase's duration (``recording``); the benches themselves are untouched.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks import run as run_mod
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.alternatives import BloomIO
from repro_torch.core.bloom import decode_scores
from repro_torch.core.counting import CountingBloomIO
from repro_torch.kernels import bloom_decode as bd
from repro_torch.kernels.common import LAUNCHES, resolve_device
from repro_torch.train import metrics as M

STEPS, SCALE = 150, 0.6
GATE = 3.0
# the metric's range per task kind
RANGES = {"recsys": (0.0, 1.0), "session": (0.0, 1.0),
          "classify": (0.0, 100.0)}


@dataclasses.dataclass
class Run:
    """One trained run: its part, task and embedding, its score, the
    counted launches it made, and for a Bloom-style embedding the shape
    of its evaluated scores and whether they equal ``decode_scores``."""
    part: str
    task: str
    method: str
    m: int
    k: Optional[int]
    score: float
    train_time: float
    eval_time: float
    launches: Dict[str, int]
    evals: int = 0
    eval_shape: Optional[tuple] = None
    decode_equal: Optional[bool] = None


def chance_score(name: str, scale: float, seed: int = 0) -> float:
    """The task's metric on seeded uniform random scores over its test
    set (the same set and the same metric call as the runner's)."""
    task = PAPER_TASKS[name]
    data = common.task_data(name, scale)
    rng = np.random.default_rng(seed)
    if task.kind == "recsys":
        p_te, q_te = data.test()
        return M.mean_average_precision(rng.random((len(p_te), task.d)),
                                        q_te, p_te)
    if task.kind == "classify":
        _, labels, n_train, _ = data
        y = labels[n_train:]
        return M.accuracy(rng.random((len(y), task.n_classes)), y)
    seqs, n_train = data
    _, tgt, _ = common.session_test(seqs, n_train)
    return M.reciprocal_rank(rng.random((len(tgt), task.d)), tgt)


def _bloom_style(emb) -> bool:
    return isinstance(emb, (BloomIO, CountingBloomIO))


@contextlib.contextmanager
def recording(runs: List[Run], part: List[str]):
    """Record every run of ``common.run_task`` into ``runs`` under the
    part named by ``part[0]``, for the duration of the block."""
    saved = dict(common.RUNNERS)

    def wrap(fn):
        def run(task, emb, **kw):
            seen = []
            bloom = _bloom_style(emb)
            if bloom:
                decode = emb.decode

                def captured(pred):
                    out = decode(pred)
                    seen.append((pred, out))   # compared after the run
                    return out
                emb.decode = captured
            before = dict(LAUNCHES)
            try:
                res = fn(task, emb, **kw)
            finally:
                if bloom:
                    del emb.decode
            launched = {n: c - before.get(n, 0) for n, c in LAUNCHES.items()
                        if c != before.get(n, 0)}
            equal = None
            if seen:
                with torch.no_grad():
                    equal = all(torch.equal(out, decode_scores(
                        emb.spec_out, torch.log_softmax(pred, dim=-1),
                        getattr(emb, "H_out", None))) for pred, out in seen)
            runs.append(Run(
                part[0], task.name, emb.name, emb.m_out,
                emb.spec_out.k if bloom else None, res["score"],
                res["train_time"], res["eval_time"], launched, len(seen),
                tuple(seen[-1][1].shape) if seen else None, equal))
            return res
        return run

    for kind, fn in saved.items():
        common.RUNNERS[kind] = wrap(fn)
    try:
        yield
    finally:
        common.RUNNERS.update(saved)


def _task_rows(device, steps, scale):
    """PTB and CADE at Baseline and at BE k = 4, m/d = 0.2."""
    for name in ("PTB", "CADE"):
        d = PAPER_TASKS[name].d
        s0 = common.run_task(name, common.baseline_embedding(d, device),
                             steps=steps, scale=scale,
                             device=device)["score"]
        yield f"tasks.{name}.m1.00", 0.0, 1.0
        si = common.run_task(name, BloomIO.build(d=d, m=int(0.2 * d), k=4,
                                                 device=device),
                             steps=steps, scale=scale, device=device)["score"]
        yield f"tasks.{name}.m0.20", 0.0, si / max(s0, 1e-9)


def _counting_rows(device, steps, scale, runs):
    """CountingBloomIO on MSD at m/d 0.1, k = 4, against Fig. 1's MSD
    Baseline run (the same steps, scale and seed)."""
    d = PAPER_TASKS["MSD"].d
    s0 = next(r.score for r in runs if r.part == "fig1" and r.task == "MSD"
              and r.method == "Baseline")
    si = common.run_task("MSD", CountingBloomIO(d, int(0.1 * d), k=4,
                                                device=device),
                         steps=steps, scale=scale, device=device)["score"]
    yield "counting.MSD.m0.10", 0.0, si / max(s0, 1e-9)


def run(device=None, steps: int = STEPS, scale: float = SCALE,
        out=print):
    """Every point of the phase on ``device``; prints (``out``) each CSV
    row as it comes.  Returns (CSV rows, recorded runs)."""
    device = resolve_device(device)
    runs: List[Run] = []
    part = [""]
    parts = [
        ("fig1", lambda: run_mod.fig1_rows(("MSD",), steps, scale, device)),
        ("fig2", lambda: run_mod.fig2_rows(steps, scale, device)),
        ("fig3", lambda: run_mod.fig3_rows(steps, scale, device)),
        ("table3", lambda: run_mod.table3_rows((("MSD", 0.1), ("YC", 0.1)),
                                               steps, scale, device)),
        ("table5", lambda: run_mod.table5_rows((("MSD", 0.1),), steps,
                                               scale, device)),
        ("tasks", lambda: _task_rows(device, steps, scale)),
        ("counting", lambda: _counting_rows(device, steps, scale, runs)),
    ]
    rows = []
    with recording(runs, part):
        for name, rows_of in parts:
            part[0] = name
            for row in rows_of():
                out(run_mod.csv_line(*row))
                rows.append(row)
    return rows, runs


def check(runs: List[Run], scale: float, on_card: bool) -> List[str]:
    """The four checks of the module docstring; returns the failures
    (empty when every run passes)."""
    failures = []
    chance = {}
    for r in runs:
        kind = PAPER_TASKS[r.task].kind
        label = f"{r.part} {r.task} {r.method} m={r.m} k={r.k}"
        if r.decode_equal is False:
            failures.append(f"{label}: Eq. 3 scores != decode_scores")
        # a Bloom-style embedding's evaluation decodes through Eq. 3 on a
        # recsys or session task (warm and timed), never on CADE
        decodes = r.k is not None and kind != "classify"
        if r.evals != (2 if decodes else 0):
            failures.append(f"{label}: {r.evals} Eq. 3 evaluations")
        want = {bd.NAME: r.evals} if on_card and r.evals else {}
        if r.launches != want:
            failures.append(f"{label}: launched {r.launches}, want {want}")
        lo, hi = RANGES[kind]
        if not (math.isfinite(r.score) and lo <= r.score <= hi):
            failures.append(f"{label}: score {r.score} outside [{lo}, {hi}]")
        if r.task not in chance:
            chance[r.task] = chance_score(r.task, scale)
        if not r.score >= GATE * chance[r.task]:
            failures.append(f"{label}: score {r.score:.6f} < {GATE} x chance "
                            f"{chance[r.task]:.6f}")
    return failures


def run_line(r: Run, chance: float) -> str:
    return (f"paper: {r.part} {r.task} {r.method} m={r.m} k={r.k}: score "
            f"{r.score:.6f}, chance {chance:.6f}, margin "
            f"{r.score / max(chance, 1e-12):.2f}x, train {r.train_time:.3f} "
            f"s, eval {r.eval_time * 1e3:.3f} ms, launches {r.launches}, "
            f"eval scores {r.eval_shape}, Eq. 3 equal {r.decode_equal}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    _, runs = run(device)
    for r in runs:
        print(run_line(r, chance_score(r.task, SCALE)), flush=True)
    margins = [r.score / chance_score(r.task, SCALE) for r in runs]
    print(f"paper: {len(runs)} runs, least margin {min(margins):.2f}x")
    failures = check(runs, SCALE, device.type == "cuda")
    for f in failures:
        print(f"paper: FAILED {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
