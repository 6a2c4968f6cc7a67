"""Decode cells re-counted at a model axis of 16 (mesh 16x16) by the
port's dry run (launch/dryrun.py): decode is weight-bandwidth bound, so
it wants the thinnest weight shards.

Usage: PYTHONPATH=src python -m repro_torch.experiments.optimized_decode
"""
import time
import traceback

from repro_torch import configs
from repro_torch.launch.dryrun import run_cell


def main():
    for arch, shape, ok, _ in configs.all_cells():
        if not ok or "decode" not in shape and shape != "long_500k":
            continue
        t0 = time.perf_counter()
        try:
            res = run_cell(arch, shape, mesh_shape=(16, 16), tag="opt",
                           out_dir="experiments/dryrun_opt_decode_torch")
            r = res.get("roofline", {})
            print(f"OK  {arch:18s} {shape:12s} "
                  f"bound={r.get('step_time_s', 0):.4f}s "
                  f"[{time.perf_counter()-t0:.0f}s]", flush=True)
        except Exception as e:  # noqa: BLE001 (reported, as the reference)
            print(f"FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    print("done")


if __name__ == "__main__":
    main()
