"""Paper Fig. 1: score ratio S_i/S_0 as a function of m/d at k = 4.

The JAX package's ``benchmarks/bench_fig1_compression.py`` on ``device``
(CUDA unless the caller asks for the CPU): the same arguments, defaults
and rows.  Expected qualitative result (paper Sec. 5.1): curves bend
toward the top-left — S_i/S_0 >= ~0.9 down to m/d = 0.2 for the sparse
tasks; the dense ML-like task degrades faster.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import baseline_embedding, run_task
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.alternatives import BloomIO

RATIOS = (0.1, 0.2, 0.3, 0.5, 0.8)


def run(tasks=("MSD", "ML"), k: int = 4, steps: int = 120,
        scale: float = 0.6, seeds=(0,), device=None):
    rows = []
    for name in tasks:
        d = PAPER_TASKS[name].d
        base = [run_task(name, baseline_embedding(d, device), steps=steps,
                         seed=s, scale=scale, device=device) for s in seeds]
        s0 = sum(b["score"] for b in base) / len(base)
        rows.append({"bench": "fig1", "task": name, "method": "Baseline",
                     "m_over_d": 1.0, "score": s0, "ratio": 1.0})
        for r in RATIOS:
            m = max(8, int(d * r))
            vals = [run_task(name, BloomIO.build(d=d, m=m, k=min(k, m),
                                                 seed=s, device=device),
                             steps=steps, seed=s, scale=scale,
                             device=device)["score"]
                    for s in seeds]
            si = sum(vals) / len(vals)
            rows.append({"bench": "fig1", "task": name, "method": f"BE k={k}",
                         "m_over_d": r, "score": si,
                         "ratio": si / max(s0, 1e-9)})
    return rows


if __name__ == "__main__":
    for row in run():
        print(row)
