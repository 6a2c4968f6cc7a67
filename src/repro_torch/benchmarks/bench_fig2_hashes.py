"""Paper Fig. 2: score ratio S_i/S_0 as a function of k (m/d = 0.3).

The JAX package's ``benchmarks/bench_fig2_hashes.py`` on ``device``
(CUDA unless the caller asks for the CPU): the same arguments, defaults
and rows.  Expected qualitative result: k = 1 (hashing trick) is clearly
worse; 2 <= k <= 4 is the sweet spot; large k degrades again.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import baseline_embedding, run_task
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.alternatives import BloomIO

KS = (1, 2, 4, 8, 16)


def run(tasks=("MSD",), m_over_d: float = 0.3, steps: int = 120,
        scale: float = 0.6, seeds=(0,), device=None):
    rows = []
    for name in tasks:
        d = PAPER_TASKS[name].d
        s0 = run_task(name, baseline_embedding(d, device), steps=steps,
                      scale=scale, device=device)["score"]
        m = int(d * m_over_d)
        for k in KS:
            vals = [run_task(name, BloomIO.build(d=d, m=m, k=k, seed=s,
                                                 device=device),
                             steps=steps, seed=s, scale=scale,
                             device=device)["score"]
                    for s in seeds]
            si = sum(vals) / len(vals)
            rows.append({"bench": "fig2", "task": name, "k": k,
                         "m_over_d": m_over_d, "score": si,
                         "ratio": si / max(s0, 1e-9)})
    return rows


if __name__ == "__main__":
    for row in run():
        print(row)
