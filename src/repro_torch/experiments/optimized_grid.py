"""Count the 32-cell grid with the reference's best-known settings
(launch/dryrun.py at the H100's rates): mesh (32, 8), adafactor for the
train cells, and ``causal_skip`` for every causal-attention train and
prefill cell, an XLA knob the port records and has no counterpart of.
Artifacts land in experiments/dryrun_opt_torch/ with tag 'opt'.

Usage: PYTHONPATH=src python -m repro_torch.experiments.optimized_grid
"""
import time
import traceback

from repro_torch import configs
from repro_torch.launch.dryrun import run_cell


def main():
    failures = 0
    for arch, shape, ok, _ in configs.all_cells():
        if not ok:
            continue
        overrides = {}
        cfg = configs.get_config(arch)
        if cfg.family not in ("ssm",) and shape in ("train_4k",
                                                    "prefill_32k"):
            overrides["causal_skip"] = True
        t0 = time.perf_counter()
        try:
            res = run_cell(arch, shape, overrides=overrides,
                           mesh_shape=(32, 8), tag="opt",
                           out_dir="experiments/dryrun_opt_torch",
                           optimizer="adafactor")
            r = res.get("roofline", {})
            print(f"OK  {arch:18s} {shape:12s} "
                  f"bound={r.get('step_time_s', 0):.4f}s "
                  f"dom={r.get('dominant','-')} "
                  f"frac={r.get('roofline_fraction', 0):.4f} "
                  f"[{time.perf_counter()-t0:.0f}s]", flush=True)
        except Exception as e:  # noqa: BLE001 (reported, as the reference)
            failures += 1
            print(f"FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    print(f"done, failures={failures}")


if __name__ == "__main__":
    main()
