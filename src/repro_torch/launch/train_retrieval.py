"""Retrieval-tower training entry point (DESIGN.md §12).

Trains the FF tower on the Zipf stream with the serving-consistent Bloom
loss (``train/retrieval_trainer.py``), serves the TRAINED tower through
``RetrievalEngine`` (the slot pool; on a GPU the decode-top-k kernel) on a
fresh eval-seed workload, and asserts the paper's margin (trained MAP
above untrained MAP, and with ``--sweep`` >= ``--min-margin``x at 1/5
compression) before it prints the ``retrieval-train: verified`` marker.

Fault tolerant: ``--ckpt`` checkpoints every ``--checkpoint-every`` steps
and resumes on a rerun; ``--fault-at S`` / ``--failpoints train_fault@S``
raise at step S (``serving/failpoints.py``): rerun the same command to
resume.  ``--table-dtype int8`` (or fp8_e4m3, bfloat16, float32) serves
through that quantized decode variant.  It runs on CUDA unless
``--device cpu`` is given, and raises when CUDA is asked for and absent.
The ranking eval materializes (B, d) scores, so it is capped at d = 2M
(``serving/retrieval.EVAL_MAX_CATALOG``): ``--config web10m`` trains and
serves, and then stops at that cap, as the reference does.

Examples:
  # one point at the config's m (eval2k: 1/5 compression)
  PYTHONPATH=src python -m repro_torch.launch.train_retrieval --steps 300

  # the compression/accuracy curve, m/d in {1/1, 1/2, 1/5, 1/10}
  PYTHONPATH=src python -m repro_torch.launch.train_retrieval --sweep

  # chaos drill on the CPU: crash at step 120, resume from the checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train_retrieval \\
      --device cpu --ckpt /tmp/rt_ckpt --fault-at 120 ; \\
  PYTHONPATH=src python -m repro_torch.launch.train_retrieval \\
      --device cpu --ckpt /tmp/rt_ckpt
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.kernels.common import resolve_device
from repro_torch.serving.failpoints import FailPlan
from repro_torch.train import retrieval_trainer as rt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="eval2k",
                    help="retrieval config preset (default: eval2k, the "
                         "full-score-eval training scale)")
    ap.add_argument("--m", type=int, default=None,
                    help="override the Bloom output dim (single-point "
                         "mode only; the sweep sets m per ratio)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=512,
                    help="training pairs drawn from the Zipf stream")
    ap.add_argument("--eval-requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="grad-accumulation chunks (0 = off)")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--seed", type=int, default=0,
                    help="training-data seed (eval always uses seed+1)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (enables resume-on-rerun)")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fault-at", type=int, default=-1,
                    help="induce a crash at this train step (sugar for "
                         "--failpoints train_fault@S)")
    ap.add_argument("--failpoints", default=None,
                    help="failpoint spec (serving/failpoints.py grammar)")
    ap.add_argument("--table-dtype", default=None,
                    choices=["auto", "float32", "bfloat16", "int8",
                             "fp8_e4m3"],
                    help="pool-logits storage dtype of the serving decode "
                         "(DESIGN.md §13; auto = f32); the eval also "
                         "reports the int8 dual-eval MAP regardless")
    ap.add_argument("--sweep", action="store_true",
                    help="run the m/d in {1/1, 1/2, 1/5, 1/10} "
                         "compression sweep instead of a single point")
    ap.add_argument("--min-margin", type=float, default=3.0,
                    help="required trained/untrained MAP ratio at 1/5 "
                         "compression (sweep)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None, help="write the report JSON")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    over = {"m": args.m} if args.m else {}
    if args.table_dtype is not None:
        over["table_dtype"] = args.table_dtype
    base = get_retrieval_config(args.config, **over)
    tc = rt.default_train_config(
        steps=args.steps, microbatch=args.microbatch,
        checkpoint_every=(args.checkpoint_every if args.ckpt else 0),
        learning_rate=args.lr)
    plan = FailPlan.parse(args.failpoints)
    if args.fault_at >= 0:
        plan = plan.merge(FailPlan.parse(f"train_fault@{args.fault_at}"))
    failpoints = plan if plan else None

    if args.sweep:
        rows = rt.compression_sweep(
            base, tc, n_pairs=args.pairs, batch_size=args.batch,
            n_eval=args.eval_requests, n_slots=args.slots,
            data_seed=args.seed, eval_seed=args.seed + 1, device=device)
        rt.assert_trained_margin(rows, min_ratio_at_5=args.min_margin)
        report = {"sweep": rows}
        head = rows[0]
    else:
        row = rt.train_and_eval_point(
            base, tc, n_pairs=args.pairs, batch_size=args.batch,
            n_eval=args.eval_requests, n_slots=args.slots,
            data_seed=args.seed, eval_seed=args.seed + 1,
            checkpoint_dir=args.ckpt, failpoints=failpoints, device=device)
        assert row["map"] > row["untrained_map"], (
            f"trained MAP {row['map']:.4f} <= untrained "
            f"{row['untrained_map']:.4f} — training is not helping")
        report = {"point": row}
        head = row

    report["verified"] = True
    report["device"] = str(device)
    print(json.dumps(report, indent=1, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    print(f"retrieval-train: verified ({head['config']}: d={head['d']}, "
          f"{head['steps']} steps on {device}, trained map "
          f"{head['map']:.4f} vs untrained {head['untrained_map']:.4f})")


if __name__ == "__main__":
    main()
