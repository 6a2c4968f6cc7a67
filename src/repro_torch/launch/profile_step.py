"""Where one full-width LM step spends its time, on a GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        [--step decode|train] [--steps 20] [--table-dtype int8] \\
        [--bwd-impl dense]

Builds qwen1.5-0.5b at full width (random weights from seed 0) and runs
``--steps`` steps of one kind:

  decode — bf16 serving weights; an 8-slot pool filled through the
           engine's prefill and insert, then decode steps over all 8 live
           slots;
  train  — f32 master weights, bf16 compute, adamw; train steps on batch
           8 x seq 64 windows of the training driver's token stream.

``--table-dtype`` (int8, fp8_e4m3, bfloat16, float32) runs the step with
the Bloom tables stored narrow: the quantized embedding and, for decode,
the per-step quantize of the (8, m) logp rows and the in-kernel-hash
decode; the quantize ops' own device time is timed apart as well.
``--bwd-impl dense`` (train) takes the Bloom embedding's backward through
the dense m-tile sweep kernel instead of the CSR scatter-add.

The steps are first timed on the host clock with a synchronise after
each, then run again under ``torch.profiler`` (CPU and CUDA activities).
Prints the mean and median step wall, the device-busy time per step
summed over every kernel, the share of each of the port's kernels and of
the top kernels by device time, and the card's name and power limit.
Needs a CUDA device; nothing here is a test.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import quant
from repro_torch.data import synthetic
from repro_torch.data.pipeline import BatchIterator, lm_batches
from repro_torch.kernels import common
from repro_torch.launch import serve
from repro_torch.launch import steps as steps_lib
from repro_torch.serving.engine import LMSlotProgram
from repro_torch.serving.loadgen import mixed_length_workload
from repro_torch.serving.scheduler import ServeStats

# substrings of the port's kernel names as the profiler lists them
PORT_KERNELS = {"bloom_embed": "embed_fwd",
                "bloom_decode_topk": "decode_topk",
                "bloom_ce_fwd": "ce_fwd", "bloom_ce_bwd": "ce_bwd",
                "bloom_csr": "csr_", "bloom_embed_bwd": "embed_bwd_dense"}


def decode_step(cfg, dev, steps: int):
    """A zero-argument decode step over an 8-slot pool, all slots live."""
    model = serve.build_model(cfg, 0, dev)
    n_slots, max_len = 8, 14 + 2 * steps + 8
    prog = LMSlotProgram(cfg, topk=8, device=dev, n_slots=n_slots,
                         max_len=max_len)
    state = prog.init_state(n_slots)
    stats = ServeStats()
    for slot, req in enumerate(mixed_length_workload(cfg.vocab, n_slots,
                                                     seed=0)):
        req.slot, req.max_gen = slot, max_len
        prog.insert(state, req, prog.prefill(model, req), stats)
    return lambda: prog.step(model, state)


def train_step(cfg, dev, batch: int = 8, seq: int = 64):
    """A zero-argument train step (the training driver's step and data)."""
    step, optimizer = steps_lib.make_train_step(
        cfg, TrainConfig(optimizer="adamw", learning_rate=3e-3))
    model = steps_lib.init_fn_for(cfg)(0).to(dev)
    state = [optimizer.init({n: p.detach()
                             for n, p in model.named_parameters()})]
    stream = synthetic.make_token_stream(batch * (seq + 1) * 64, cfg.vocab)
    it = BatchIterator([lm_batches(stream, batch, seq)], batch)

    def run():
        tokens = torch.as_tensor(next(it)[0]).to(dev)
        state[0], _ = step(model, state[0], {"tokens": tokens})

    run()     # warm-up, outside the timed and the profiled steps
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", choices=("decode", "train"), default="decode")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--table-dtype", default="auto",
                    choices=("auto", *quant.TABLE_DTYPES))
    ap.add_argument("--bwd-impl", default="csr", choices=("csr", "dense"),
                    help="the Bloom embedding's backward in a train step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    dev = torch.device("cuda")
    common.build()
    cfg = configs.get_config("qwen1.5-0.5b", table_dtype=args.table_dtype,
                             bwd_impl=args.bwd_impl)
    fn = (decode_step(cfg, dev, args.steps) if args.step == "decode"
          else train_step(cfg, dev))

    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            fn()
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
    print(f"profile: {cfg.name} {args.step} step, table_dtype "
          f"{cfg.table_dtype}, bwd_impl {cfg.bwd_impl}, {args.steps} steps: "
          f"wall "
          f"{wall_ms:.6f} ms per step (median "
          f"{float(np.median(walls)) * 1e3:.6f}), device busy "
          f"{busy / 1e3:.6f} ms per step"
          + (f" ({busy / 1e3 / wall_ms:.4f} of the wall)" if busy else
             " (the profiler recorded no device time: not measured)"))
    for name, sub in PORT_KERNELS.items():
        us = sum(v for k, v in dev_us.items() if sub in k) / args.steps
        if us:
            print(f"profile: {name}: {us:.3f} us per step"
                  + (f", {us / busy:.4f} of device busy" if busy else ""))
    if args.step == "decode" and args.table_dtype != "auto":
        logp = torch.log_softmax(torch.randn(8, cfg.m_vocab, device=dev), -1)
        q_ms = common.graph_time_ms(
            lambda: quant.quantize_table(logp, args.table_dtype))
        print(f"profile: quantize of the (8, {cfg.m_vocab}) logp rows "
              f"({args.table_dtype}): {q_ms * 1e3:.3f} us per step on the "
              f"device (CUDA graph replays, timed apart)")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:15]
    for k, v in top:
        print(f"profile:   {v / args.steps:10.3f} us/step  {k[:100]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
