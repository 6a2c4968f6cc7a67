"""Hillclimb: count one dry-run variant of a cell (launch/dryrun.py)
and print the roofline deltas vs the stored baseline artifact (by
default the port's dry-run artifact of the cell).

Usage:
  PYTHONPATH=src python -m repro_torch.experiments.hillclimb \\
      --arch qwen3-4b --shape train_4k --tag it2_opt \\
      --opt adafactor [--mesh 32x8] [--override causal_skip=true]
"""
import argparse
import json

from repro_torch.launch.dryrun import OUT_DIR, run_cell


def parse_override(s):
    k, v = s.split("=", 1)
    if v.lower() in ("true", "false"):
        v = v.lower() == "true"
    else:
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--mesh", default=None, help="e.g. 32x8")
    ap.add_argument("--out", default="experiments/perf_torch")
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-1: shard optimizer moments over data")
    ap.add_argument("--baseline", default=None,
                    help="baseline artifact (default: the dryrun one)")
    args = ap.parse_args(argv)

    overrides = dict(parse_override(s) for s in args.override)
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)

    res = run_cell(args.arch, args.shape, overrides=overrides,
                   mesh_shape=mesh_shape, out_dir=args.out, tag=args.tag,
                   zero=args.zero, optimizer=args.opt)

    base_path = args.baseline or (
        f"{OUT_DIR}/{args.arch}__{args.shape}__singlepod.json")
    with open(base_path) as f:
        base = json.load(f)

    br, nr = base["roofline"], res["roofline"]
    bt = base["full"]["memory"]["temp_bytes"] / 2**30
    nt = res["full"]["memory"]["temp_bytes"] / 2**30

    def d(n, b):
        return f"{n:9.4f} ({(n-b)/b*100:+6.1f}%)" if b else f"{n:9.4f}"

    print(f"\n=== {args.arch} {args.shape} [{args.tag}] "
          f"overrides={overrides} mesh={mesh_shape or 'default'} ===")
    for key in ("compute_s", "memory_s", "collective_s"):
        print(f"  {key:13s} {d(nr[key], br[key])}   (base {br[key]:.4f})")
    print(f"  {'temp_GiB':13s} {d(nt, bt)}   (base {bt:.2f})")
    gain = (nr["step_time_s"] - br["step_time_s"]) / br["step_time_s"]
    print(f"  dominant: {nr['dominant']}  step bound "
          f"{nr['step_time_s']:.4f} (base {br['step_time_s']:.4f}, "
          f"{gain * 100:+.1f}%)")
    print(f"  MODEL/HLO flops: {nr['model_flops_ratio']:.3f} "
          f"(base {br['model_flops_ratio']:.3f})")
    print(f"  roofline fraction: {nr['roofline_fraction']:.4f} "
          f"(base {br['roofline_fraction']:.4f})")


if __name__ == "__main__":
    main()
