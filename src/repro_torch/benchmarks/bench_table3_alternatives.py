"""Paper Table 3: BE (k=3,4,5) vs HT / ECOC / PMI / CCA at fixed m/d.

The JAX package's ``benchmarks/bench_table3_alternatives.py`` on
``device`` (CUDA unless the caller asks for the CPU): the same arguments,
defaults and rows; the ECOC, PMI and CCA fits run on the host before
``run_task``, outside its timed windows.  Expected qualitative result: BE
wins most (task, m/d) test points, by a large margin over HT/ECOC;
PMI/CCA are competitive only on their favorable tasks (CADE-like
input-only classification / AMZ-like co-occurrence-rich).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from repro_torch.benchmarks.common import (baseline_embedding, run_task,
                                           task_data)
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.alternatives import (BloomIO, CCAIO, ECOCIO, PMIIO,
                                           hashing_trick)


def _input_matrix(name, scale):
    data = task_data(name, scale)
    t = PAPER_TASKS[name]
    if t.kind == "recsys":
        return data.X_in, data.X_out
    if t.kind == "classify":
        return data[3], data[3]
    # sessions: bag-of-items per session
    seqs, _ = data
    n, d = len(seqs), t.d
    rows, cols = [], []
    for i, s in enumerate(seqs):
        for it in s[s >= 0]:
            rows.append(i)
            cols.append(int(it))
    X = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, d))
    X.data[:] = 1.0
    return X, X


def build_methods(name, m, scale, seed=0, device=None):
    t = PAPER_TASKS[name]
    X_in, X_out = _input_matrix(name, scale)
    return {
        "HT": hashing_trick(t.d, m, seed=seed, device=device),
        "ECOC": ECOCIO.build(t.d, m, seed=seed, iters=60, device=device),
        "PMI": PMIIO.build(X_in, min(m, 128), seed=seed, device=device),
        "CCA": CCAIO.build(X_in, X_out, min(m, 128), seed=seed,
                           device=device),
        "BE k=3": BloomIO.build(d=t.d, m=m, k=3, seed=seed, device=device),
        "BE k=4": BloomIO.build(d=t.d, m=m, k=4, seed=seed, device=device),
        "BE k=5": BloomIO.build(d=t.d, m=m, k=5, seed=seed, device=device),
    }


def run(points=(("MSD", 0.1), ("MSD", 0.2), ("YC", 0.1)),
        steps: int = 120, scale: float = 0.5, device=None):
    rows = []
    for name, r in points:
        t = PAPER_TASKS[name]
        s0 = run_task(name, baseline_embedding(t.d, device), steps=steps,
                      scale=scale, device=device)["score"]
        m = max(16, int(t.d * r))
        for meth, emb in build_methods(name, m, scale,
                                       device=device).items():
            res = run_task(name, emb, steps=steps, scale=scale,
                           device=device)
            rows.append({"bench": "table3", "task": name, "m_over_d": r,
                         "method": meth, "score": res["score"],
                         "ratio": res["score"] / max(s0, 1e-9)})
    return rows


if __name__ == "__main__":
    for row in run():
        print(row)
