"""Paper Fig. 3: training-time and evaluation-time ratios T_i/T_0 vs m/d.

The JAX package's ``benchmarks/bench_fig3_time.py`` on ``device`` (CUDA
unless the caller asks for the CPU): the same arguments, defaults and
rows; the times are ``common.run_task``'s (host clock, the card
synchronised).  Expected qualitative result: training time drops
~linearly with m/d (~2x speedup at 2x compression); evaluation time
(incl. Eq. 3 recovery) stays below ~1.5x of baseline.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import baseline_embedding, run_task
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.alternatives import BloomIO

RATIOS = (0.1, 0.2, 0.3, 0.5, 0.8)


def run(tasks=("MSD",), k: int = 4, steps: int = 150, scale: float = 0.6,
        device=None):
    rows = []
    for name in tasks:
        d = PAPER_TASKS[name].d
        base = run_task(name, baseline_embedding(d, device), steps=steps,
                        scale=scale, device=device)
        rows.append({"bench": "fig3", "task": name, "m_over_d": 1.0,
                     "train_ratio": 1.0, "eval_ratio": 1.0,
                     "train_time": base["train_time"],
                     "eval_time": base["eval_time"]})
        for r in RATIOS:
            m = max(8, int(d * r))
            res = run_task(name, BloomIO.build(d=d, m=m, k=min(k, m),
                                               device=device),
                           steps=steps, scale=scale, device=device)
            rows.append({
                "bench": "fig3", "task": name, "m_over_d": r,
                "train_ratio": res["train_time"] / base["train_time"],
                "eval_ratio": res["eval_time"] / max(base["eval_time"],
                                                     1e-9),
                "train_time": res["train_time"],
                "eval_time": res["eval_time"]})
    return rows


if __name__ == "__main__":
    for row in run():
        print(row)
