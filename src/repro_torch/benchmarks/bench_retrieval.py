"""Retrieval-training benchmark of the port: the paper's
compression/accuracy curve at serving scale (DESIGN.md §12), the twin of
``benchmarks/bench_retrieval.py``.

Runs the seeded train + serve + eval sweep of
``train/retrieval_trainer.py``: m/d in {1/1, 1/2, 1/5, 1/10} on the eval2k
catalog, each point trained on the Zipf stream and evaluated end to end
through ``RetrievalEngine``'s slot loop (on a GPU, through the decode-top-k
kernel) with tie-aware MAP/RR/accuracy.  Same sweep constants and the same
gates as the JAX package's bench:

  * the deterministic integers (catalog and compression, train steps, pair
    counts, the served schedule's decode_steps, n_evaluated) equal the
    committed ``BENCH_retrieval.json`` rows (``--check``; the file is only
    read);
  * on the FRESH values, every run: trained MAP >= MIN_MARGIN_AT_5 x
    untrained at 1/5 compression and strictly above it at every point; MAP
    at 1/5 >= MIN_RETENTION_AT_5 of the 1/1 point; the int8 dual-eval MAP
    >= MIN_INT8_RETENTION of the f32 MAP at every point.  Float metrics
    are never exact-matched.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_retrieval \\
        [--check] [--device cpu] [--out snapshot.json]

writes a snapshot only where ``--out`` points (never the committed file).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.kernels.common import resolve_device
from repro_torch.train import retrieval_trainer as rt

JSON_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "BENCH_retrieval.json"

# trained/untrained MAP ratio at 1/5 compression
MIN_MARGIN_AT_5 = 3.0
# MAP at 1/5 compression keeps at least this fraction of the 1/1 point
MIN_RETENTION_AT_5 = 0.2
# the int8 dual-eval MAP keeps at least this fraction of the f32 MAP
MIN_INT8_RETENTION = 0.9

# sweep shape (seeded; the committed rows depend on every one of these)
CONFIG = "eval2k"
STEPS = 300
N_PAIRS = 512
BATCH = 64
N_EVAL = 64
N_SLOTS = 8
DATA_SEED = 0
EVAL_SEED = 1

CHECKED_FIELDS = ("d", "m", "k", "ratio", "steps", "n_train_pairs",
                  "n_eval_requests", "n_evaluated", "decode_steps")
FLOAT_FIELDS = ("map", "rr", "accuracy", "final_loss", "untrained_map",
                "untrained_rr", "map_int8", "int8_retention")


def run_sweep(device=None) -> list[dict]:
    base = get_retrieval_config(CONFIG)
    tc = rt.default_train_config(steps=STEPS)
    rows = rt.compression_sweep(
        base, tc, n_pairs=N_PAIRS, batch_size=BATCH, n_eval=N_EVAL,
        n_slots=N_SLOTS, data_seed=DATA_SEED, eval_seed=EVAL_SEED,
        device=device)
    for row in rows:
        row["name"] = f"retrieval_train.{row.pop('config')}"
        for f in FLOAT_FIELDS:
            row[f] = round(float(row[f]), 6)
    return rows


def gate_margins(rows: list[dict]) -> list[str]:
    """The fresh-value gates (see module doc); returns the failures."""
    failures = []
    try:
        rt.assert_trained_margin(
            [dict(r, config=r["name"]) for r in rows],
            min_ratio_at_5=MIN_MARGIN_AT_5)
    except AssertionError as e:
        failures.append(str(e))
    by_ratio = {r["ratio"]: r for r in rows}
    if 1.0 in by_ratio and 5.0 in by_ratio:
        full, fifth = by_ratio[1.0]["map"], by_ratio[5.0]["map"]
        if fifth < MIN_RETENTION_AT_5 * full:
            failures.append(
                f"map at 1/5 compression ({fifth:.4f}) retains < "
                f"{MIN_RETENTION_AT_5} of the uncompressed point "
                f"({full:.4f})")
    else:
        failures.append("the sweep lacks the 1/1 or the 1/5 point")
    for r in rows:
        if r["map_int8"] < MIN_INT8_RETENTION * r["map"]:
            failures.append(
                f"{r['name']}: int8 dual-eval MAP {r['map_int8']:.4f} "
                f"retains < {MIN_INT8_RETENTION} of the f32 MAP "
                f"({r['map']:.4f})")
    return failures


def check_against(rows, path=JSON_PATH) -> list[str]:
    """The committed rows' integer fields against the fresh rows', then
    the gates; returns the failures."""
    committed = {r["name"]: r for r in
                 json.loads(path.read_text())["rows"]}
    fresh = {r["name"]: r for r in rows}
    failures = [f"{name}: committed row missing from the fresh run"
                for name in sorted(set(committed) - set(fresh))]
    for name, r in fresh.items():
        old = committed.get(name)
        if old is None:
            failures.append(f"{name}: no such row in {path.name}")
            continue
        for f in CHECKED_FIELDS:
            if old.get(f) != r.get(f):
                failures.append(f"{name}.{f}: committed {old.get(f)}, "
                                f"fresh {r.get(f)}")
    return failures + gate_margins(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help=f"hold the fresh sweep's integers against "
                         f"{JSON_PATH.name} (read only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the fresh rows as a snapshot here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rows = run_sweep(device)
    for r in rows:
        print(r)
    failures = check_against(rows) if args.check else gate_margins(rows)
    if args.out:
        payload = {
            "generated_by": "PYTHONPATH=src python -m "
                            "repro_torch.benchmarks.bench_retrieval",
            "device": str(device),
            "min_margin_at_5": MIN_MARGIN_AT_5,
            "min_retention_at_5": MIN_RETENTION_AT_5,
            "min_int8_retention": MIN_INT8_RETENTION,
            "rows": rows,
        }
        pathlib.Path(args.out).write_text(
            json.dumps(payload, indent=1, sort_keys=True) + "\n")
        print(f"wrote {args.out}")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)
    print(f"{'check' if args.check else 'gates'} ok: {len(rows)} rows on "
          f"{device}" + (f" vs {JSON_PATH.name}" if args.check else ""))


if __name__ == "__main__":
    main()
