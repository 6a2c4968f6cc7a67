"""Where one full-width LM decode step spends its time, on a GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode [--steps 20]

Builds qwen1.5-0.5b at full width (bf16, random weights from seed 0),
fills an 8-slot pool through the engine's prefill and insert, then runs
``--steps`` decode steps over all 8 live slots: first timed on the host
clock with a synchronise after each step, then under ``torch.profiler``
(CPU and CUDA activities).  Prints the mean step wall, the device-busy
time per step summed over every kernel, the share of each of the port's
two kernels (bloom_embed, bloom_decode_topk) and of the top kernels by
device time, and the card's name and power limit.  Needs a CUDA device;
nothing here is a test.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.serving.engine import LMSlotProgram
from repro_torch.serving.loadgen import mixed_length_workload
from repro_torch.serving.scheduler import ServeStats

# substrings of the port's kernel names as the profiler lists them
PORT_KERNELS = {"bloom_embed": "embed_fwd", "bloom_decode_topk": "decode_topk"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    dev = torch.device("cuda")
    cfg = configs.get_config("qwen1.5-0.5b")
    model = serve.build_model(cfg, 0, dev)
    n_slots, max_len = 8, 14 + 2 * args.steps + 8
    prog = LMSlotProgram(cfg, topk=8, device=dev, n_slots=n_slots,
                         max_len=max_len)
    state = prog.init_state(n_slots)
    stats = ServeStats()
    for slot, req in enumerate(mixed_length_workload(cfg.vocab, n_slots,
                                                     seed=0)):
        req.slot, req.max_gen = slot, max_len
        prog.insert(state, req, prog.prefill(model, req), stats)

    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.step(model, state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            prog.step(model, state)
        torch.cuda.synchronize()
    dev_us = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.key] = dev_us.get(e.key, 0.0) + us
    busy = sum(dev_us.values()) / args.steps
    wall_ms = float(np.mean(walls)) * 1e3
    print(f"profile: {cfg.name} decode step, {n_slots} live slots, "
          f"{args.steps} steps: wall {wall_ms:.6f} ms per step "
          f"(median {float(np.median(walls)) * 1e3:.6f}), device busy "
          f"{busy / 1e3:.6f} ms per step"
          + (f" ({busy / 1e3 / wall_ms:.4f} of the wall)" if busy else
             " (the profiler recorded no device time: not measured)"))
    for name, sub in PORT_KERNELS.items():
        us = sum(v for k, v in dev_us.items() if sub in k) / args.steps
        print(f"profile: {name}: {us:.3f} us per step"
              + (f", {us / busy:.4f} of device busy" if busy else ""))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    for k, v in top:
        print(f"profile:   {v / args.steps:10.3f} us/step  {k[:100]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
