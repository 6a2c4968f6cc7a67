"""Paper-style experiment: BE vs Baseline on an MSD-like task.

Runs the paper's core comparison end to end on synthetic data matched to
the MSD statistics: the Bloom-embedded model's score against the
baseline's (Fig. 1) and its train time (Fig. 3), at m/d = 0.5, 0.2 and
0.1.  The twin of ``examples/train_recommender.py``, through the paper
benches' ``run_task`` (``repro_torch.benchmarks.common``) on ``--device``.
The data seed is the task name's ``hash``: pin ``PYTHONHASHSEED`` to
repeat a run.

Run:  PYTHONHASHSEED=0 PYTHONPATH=src python -m \\
          repro_torch.examples.train_recommender [--quick] [--device cpu]
"""
import argparse

from repro_torch.benchmarks.common import baseline_embedding, run_task
from repro_torch.configs.paper_tasks import PAPER_TASKS
from repro_torch.core.alternatives import BloomIO
from repro_torch.kernels.common import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="MSD", choices=list(PAPER_TASKS))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = 80 if args.quick else 200
    scale = 0.4 if args.quick else 1.0

    t = PAPER_TASKS[args.task]
    base = run_task(args.task, baseline_embedding(t.d, device), steps=steps,
                    scale=scale, device=device)
    print(f"[{args.task}] baseline:  score={base['score']:.4f}  "
          f"train={base['train_time']:.1f}s "
          f"eval={base['eval_time'] * 1e3:.0f}ms")

    rows = [dict(base, ratio=0.0)]
    for ratio in (0.5, 0.2, 0.1):
        m = int(t.d * ratio)
        be = run_task(args.task, BloomIO.build(d=t.d, m=m, k=4,
                                               device=device),
                      steps=steps, scale=scale, device=device)
        print(f"[{args.task}] BE m/d={ratio:.1f}: "
              f"score={be['score']:.4f} "
              f"(S_i/S_0={be['score'] / max(base['score'], 1e-9):.3f})  "
              f"train={be['train_time']:.1f}s "
              f"(T_i/T_0={be['train_time'] / base['train_time']:.2f})  "
              f"eval={be['eval_time'] * 1e3:.0f}ms")
        rows.append(dict(be, ratio=ratio))
    return rows


if __name__ == "__main__":
    main()
