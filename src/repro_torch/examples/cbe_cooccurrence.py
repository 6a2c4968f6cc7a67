"""CBE demo (paper Sec. 6): redirect Bloom collisions onto co-occurring
item pairs and measure the gain over plain BE.

The twin of ``examples/cbe_cooccurrence.py``, through the port's Table 5
bench (``repro_torch.benchmarks.bench_table5_cbe``) on ``--device``.  The
data seed is the task name's ``hash``: pin ``PYTHONHASHSEED`` to repeat a
run.

Run:  PYTHONHASHSEED=0 PYTHONPATH=src python -m \\
          repro_torch.examples.cbe_cooccurrence [--device cpu]
"""
import argparse

from repro_torch.benchmarks.bench_table5_cbe import run
from repro_torch.kernels.common import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    rows = run(points=(("MSD", 0.1),), steps=150, scale=0.5,
               device=resolve_device(args.device))
    for row in rows:
        print(f"task={row['task']} m/d={row['m_over_d']}  "
              f"input co-occurrence: {row['cooc_pct_in']:.1f}% of pairs "
              f"(rho={row['cooc_rho_in']:.2e})")
        print(f"  BE  S_i/S_0 = {row['be_ratio']:.3f}")
        print(f"  CBE S_i/S_0 = {row['cbe_ratio']:.3f} "
              f"({row['cbe_minus_be_pct']:+.1f}% vs BE)")
    return rows


if __name__ == "__main__":
    main()
