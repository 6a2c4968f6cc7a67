"""Paper headline at LM scale: Bloom IO vs dense IO for qwen3-4b train_4k
on the mesh (32, 8), counted by the port's dry run (launch/dryrun.py) at
the H100's rates: compression of the vocab boundary vs step cost.
``causal_skip`` is the reference's XLA knob: recorded, no counterpart.

Usage: PYTHONPATH=src python -m repro_torch.experiments.bloom_vs_dense
"""
from repro_torch.launch.dryrun import run_cell


def main():
    for bloom in (True, False):
        res = run_cell("qwen3-4b", "train_4k", bloom=bloom,
                       overrides={"causal_skip": True}, mesh_shape=(32, 8),
                       tag="cmp", out_dir="experiments/perf_torch",
                       optimizer="adafactor")
        r = res["roofline"]
        m = res["full"]["memory"]
        print(f"bloom={bloom} params={res['param_count'] / 1e9:.2f}B "
              f"bound={r['step_time_s']:.4f}s compute={r['compute_s']:.4f} "
              f"memory={r['memory_s']:.4f} coll={r['collective_s']:.4f} "
              f"args={m['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={m['temp_bytes'] / 2**30:.2f}GiB", flush=True)


if __name__ == "__main__":
    main()
