"""The paper benches' entry: one module per paper table or figure.

The paper parts of the JAX package's ``benchmarks/run.py`` on ``--device``
(CUDA unless ``--device cpu``).  Prints ``name,us_per_call,derived`` CSV
rows, the reference's names and columns: score ratios (derived =
S_i/S_0) and, for Fig. 3, train time per step and eval time
(us_per_call) beside the time ratios; and the ``serving`` part, the
rows of ``bench_serving`` (the utilization, or for a ``.speedup`` row the
continuous/static decode-step speedup, as derived; the run's wall in
us_per_call), held to ``BENCH_serving.json`` but never written to it
(the reference refreshes the file; a difference from it is printed to
stderr); the ``kernels`` part, the 69 rows of ``bench_kernels`` (the
port kernel's H100 bound in microseconds as us_per_call, where the
reference prints its TPU model, and max_err as derived), held to
``BENCH_kernels.json`` with ``--quick`` (the committed rows' check
shapes) and never written to it, a difference printed to stderr; and
the ``roofline`` part, a row for each dry-run artifact with a roofline
(``roofline_table``, reading ``experiments/dryrun_torch/``, which
``python -m repro_torch.launch.dryrun --all`` writes): the dominant
term's seconds as us_per_call and MODEL/counted FLOPs as derived.

Full-budget run: PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.benchmarks.run
Quick run:       PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.benchmarks.run --quick
(``PYTHONHASHSEED`` pins the tasks' data seed, ``common.task_data``.)
"""
from __future__ import annotations

import argparse
import sys

PARTS = ("fig1", "fig2", "fig3", "table3", "table5", "kernels",
         "serving", "roofline")


def fig1_rows(tasks, steps, scale, device):
    from repro_torch.benchmarks import bench_fig1_compression as f1
    for row in f1.run(tasks=tasks, steps=steps, scale=scale, device=device):
        yield f"fig1.{row['task']}.m{row['m_over_d']:.2f}", 0.0, row["ratio"]


def fig2_rows(steps, scale, device):
    from repro_torch.benchmarks import bench_fig2_hashes as f2
    for row in f2.run(steps=steps, scale=scale, device=device):
        yield f"fig2.{row['task']}.k{row['k']}", 0.0, row["ratio"]


def fig3_rows(steps, scale, device):
    from repro_torch.benchmarks import bench_fig3_time as f3
    for row in f3.run(steps=steps, scale=scale, device=device):
        name = f"fig3.{row['task']}.m{row['m_over_d']:.2f}"
        yield (f"{name}.train", 1e6 * row["train_time"] / max(steps, 1),
               row["train_ratio"])
        yield f"{name}.eval", 1e6 * row["eval_time"], row["eval_ratio"]


def table3_rows(points, steps, scale, device):
    from repro_torch.benchmarks import bench_table3_alternatives as t3
    for row in t3.run(points=points, steps=steps, scale=scale,
                      device=device):
        yield (f"table3.{row['task']}.m{row['m_over_d']:.2f}."
               f"{row['method'].replace(' ', '')}", 0.0, row["ratio"])


def table5_rows(points, steps, scale, device):
    from repro_torch.benchmarks import bench_table5_cbe as t5
    for row in t5.run(points=points, steps=steps, scale=scale,
                      device=device):
        name = f"table5.{row['task']}.m{row['m_over_d']:.2f}"
        yield f"{name}.BE", 0.0, row["be_ratio"]
        yield f"{name}.CBE", 0.0, row["cbe_ratio"]


def kernel_rows(quick, device):
    from repro_torch.benchmarks import bench_kernels as bk
    rows = bk.run(device, quick=quick)
    for row in rows:
        yield f"kernels.{row['name']}", row["h100_us_bound"], row["max_err"]
    if not quick:
        print(f"kernels: not held to {bk.JSON_PATH.name}: its rows are "
              "--quick's check shapes", file=sys.stderr)
        return
    for failure in bk.check_against(rows):
        print(f"kernels: differs from {bk.JSON_PATH.name}: {failure}",
              file=sys.stderr)


def serving_rows(device):
    from repro_torch.benchmarks import bench_serving as bs
    rows = bs.run(device)   # one seeded run per case: no quick/full split
    for row in rows:
        if row["name"].endswith(".speedup"):
            yield f"serving.{row['name']}", 0.0, row["decode_step_speedup"]
        else:
            yield (f"serving.{row['name']}", 1e6 * row.get("wall_s", 0.0),
                   row["utilization"])
    for failure in bs.check_against(rows):
        print(f"serving: differs from {bs.JSON_PATH.name}: {failure}",
              file=sys.stderr)


def roofline_rows():
    from repro_torch.benchmarks import roofline_table as rt
    for row in rt.run():
        yield (f"roofline.{row['arch']}.{row['shape']}",
               1e6 * max(row["compute_s"], row["memory_s"],
                         row["collective_s"]),
               row["model_flops_ratio"])


def csv_line(name, us, derived) -> str:
    return f"{name},{us:.2f},{derived:.4f}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset: " + ",".join(PARTS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    quick = args.quick
    steps = 60 if quick else 150
    scale = 0.35 if quick else 0.6
    only = set(args.only.split(",")) if args.only else None
    if only is not None and not only <= set(PARTS):
        bad = sorted(only - set(PARTS))
        ap.error(f"unknown parts {bad}: the parts are {','.join(PARTS)}")
    from repro_torch.kernels.common import resolve_device
    device = resolve_device(args.device)

    def want(name):
        return only is None or name in only

    parts = []
    if want("fig1"):
        parts.append(fig1_rows(("MSD",) if quick else ("MSD", "ML", "AMZ"),
                               steps, scale, device))
    if want("fig2"):
        parts.append(fig2_rows(steps, scale, device))
    if want("fig3"):
        parts.append(fig3_rows(steps, scale, device))
    if want("table3"):
        parts.append(table3_rows(
            (("MSD", 0.1),) if quick
            else (("MSD", 0.1), ("MSD", 0.2), ("YC", 0.1)),
            steps, scale, device))
    if want("table5"):
        parts.append(table5_rows(
            (("MSD", 0.1),) if quick
            else (("MSD", 0.1), ("MSD", 0.3), ("AMZ", 0.2)),
            steps, scale, device))
    if want("kernels"):
        parts.append(kernel_rows(quick, device))
    if want("serving"):
        parts.append(serving_rows(device))
    if want("roofline"):
        parts.append(roofline_rows())
    for rows in parts:
        for row in rows:
            print(csv_line(*row), flush=True)


if __name__ == "__main__":
    main()
