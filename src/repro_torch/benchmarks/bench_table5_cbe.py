"""Paper Tables 4/5: co-occurrence-based Bloom embeddings (CBE) vs BE.

The JAX package's ``benchmarks/bench_table5_cbe.py`` on ``device`` (CUDA
unless the caller asks for the CPU): the same arguments, defaults and
rows; Algorithm 1 (``core.cbe``) runs on the host before ``run_task``.
Expected qualitative result: CBE gives moderate average gains over BE
(largest on co-occurrence-rich data), plus the Table 4 co-occurrence
statistics of each dataset.
"""
from __future__ import annotations

from repro_torch.benchmarks.bench_table3_alternatives import _input_matrix
from repro_torch.benchmarks.common import baseline_embedding, run_task
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core import hashing
from repro_torch.core.alternatives import BloomIO
from repro_torch.core.cbe import cbe_hash_matrix, cooccurrence_stats


def run(points=(("MSD", 0.1), ("MSD", 0.3)), k: int = 4,
        steps: int = 120, scale: float = 0.5, max_pairs: int = 20_000,
        device=None):
    rows = []
    for name, r in points:
        t = PAPER_TASKS[name]
        X_in, X_out = _input_matrix(name, scale)
        pct_in, rho_in = cooccurrence_stats(X_in)
        s0 = run_task(name, baseline_embedding(t.d, device), steps=steps,
                      scale=scale, device=device)["score"]
        m = max(16, int(t.d * r))

        be = BloomIO.build(d=t.d, m=m, k=k, seed=0, device=device)
        s_be = run_task(name, be, steps=steps, scale=scale,
                        device=device)["score"]

        H_in = hashing.make_hash_matrix_np(t.d, k, m, seed=0)
        H_out = hashing.make_hash_matrix_np(t.d, k, m, seed=1)
        H_in2 = cbe_hash_matrix(X_in, H_in, m, seed=0,
                                max_pairs=max_pairs)
        H_out2 = cbe_hash_matrix(X_out, H_out, m, seed=1,
                                 max_pairs=max_pairs)
        cbe = BloomIO.build(d=t.d, m=m, k=k, seed=0, H_in=H_in2,
                            H_out=H_out2, name="CBE", device=device)
        s_cbe = run_task(name, cbe, steps=steps, scale=scale,
                         device=device)["score"]

        rows.append({
            "bench": "table5", "task": name, "m_over_d": r, "k": k,
            "cooc_pct_in": pct_in, "cooc_rho_in": rho_in,
            "be_ratio": s_be / max(s0, 1e-9),
            "cbe_ratio": s_cbe / max(s0, 1e-9),
            "cbe_minus_be_pct": 100 * (s_cbe - s_be) / max(s0, 1e-9),
        })
    return rows


if __name__ == "__main__":
    for row in run():
        print(row)
