"""Aggregate the dry run's per-cell artifacts (``launch/dryrun.py``, by
default ``experiments/dryrun_torch/``) into the roofline table: one row a
cell with its compute, memory and collective terms at the H100's rates,
the dominant term, the step bound, MODEL/counted FLOPs and the temporary
bytes a rank; and the multi-pod table of memory and count times.  The
same functions, columns and rows as the JAX package's
``benchmarks/roofline_table.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR


def load_cells(out_dir: str = OUT_DIR, tag: str = "singlepod",
               dense: bool = False):
    """The artifacts ``<arch>__<shape>__<tag>[__dense].json`` of
    ``out_dir``, sorted by path (the Bloom ones unless ``dense``)."""
    rows = []
    suffix = "__dense" if dense else ""
    for path in sorted(glob.glob(os.path.join(
            out_dir, f"*__{tag}{suffix}.json"))):
        if not dense and path.endswith("__dense.json"):
            continue
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_table(rows, include_memory_analysis: bool = True):
    """The markdown roofline table: a row for each artifact that has a
    ``roofline``."""
    header = ("| arch | shape | compute s | memory s | collective s | "
              "dominant | step bound s | MODEL/HLO flops | temp GiB |")
    lines = [header, "|" + "---|" * 9]
    for d in rows:
        if "roofline" not in d:
            continue
        r = d["roofline"]
        temp = d.get("full", {}).get("memory", {}).get("temp_bytes", 0)
        lines.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant'].replace('_s', '')} | {r['step_time_s']:.4f} | "
            f"{r['model_flops_ratio']:.3f} | {temp / 2**30:.2f} |")
    return "\n".join(lines)


def fmt_multipod(rows):
    """The markdown table of each artifact's mesh, temp and argument GiB
    and count seconds."""
    lines = ["| arch | shape | mesh | temp GiB | args GiB | compile s |",
             "|" + "---|" * 6]
    for d in rows:
        mem = d.get("full", {}).get("memory", {})
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            f"{mem.get('temp_bytes', 0) / 2**30:.2f} | "
            f"{mem.get('argument_bytes', 0) / 2**30:.2f} | "
            f"{d.get('full', {}).get('compile_s', 0):.0f} |")
    return "\n".join(lines)


def run(quick: bool = True, out_dir: str = OUT_DIR):
    """One {"bench": "roofline", arch, shape, the terms} dict for each
    single-pod artifact that has a roofline (``benchmarks/run.py``'s
    ``roofline`` part)."""
    out = []
    for d in load_cells(out_dir):
        if "roofline" not in d:
            continue
        r = d["roofline"]
        out.append({"bench": "roofline", "arch": d["arch"],
                    "shape": d["shape"], "dominant": r["dominant"],
                    "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                    "collective_s": r["collective_s"],
                    "model_flops_ratio": r["model_flops_ratio"]})
    return out


if __name__ == "__main__":
    print(fmt_table(load_cells()))
    print()
    print(fmt_multipod(load_cells(tag="multipod")))
