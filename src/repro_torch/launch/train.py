"""End-to-end LM training driver.

Trains ``--arch`` (its smoke config by default, the full config with
``--full``) from random weights drawn from ``--seed`` on the CPU in f32,
moved to the device as the f32 master; every step casts them to the
compute dtype, and with Bloom IO on a GPU it runs the hand-written CUDA
kernels: the ``bloom_embed`` forward, the ``bloom_ce`` forward and
backward, and the embedding's backward: the CSR scatter-add, or with
``--bwd-impl dense`` the dense m-tile sweep (``bloom_embed_bwd``).
``--table-dtype`` (int8, fp8_e4m3, bfloat16, float32) trains through a
quantized embedding forward (the ``bloom_embed.<storage>`` variant) with
the gradient straight-through into the master table.  The ``vlm`` and
``audio`` families (pixtral-12b, whisper-small) get zero frontend
embeddings (frames) of ``max(4, seq // 4)`` rows in every batch, as in
the reference.

Fault tolerant as the reference's driver is:

  * checkpoints (params, optimizer state and the data cursor) every
    ``max(steps // 4, 10)`` steps and at the end, atomic, keep-K, in the
    reference's npz + manifest format; rerun the same command with the
    same ``--ckpt`` to resume from the newest readable one;
  * ``--fault-at S`` / ``--failpoints train_fault@S`` raise at step S
    (``serving/failpoints.py``), after the checkpoint in flight is
    written.

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent.  ``--microbatch`` is accepted and not read, as in
the reference's LM step.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --full --steps 20 [--bwd-impl dense]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --device cpu --steps 16 [--ckpt /tmp/ckpt_qwen]
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --full --steps 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic
from repro_torch.data.pipeline import BatchIterator, lm_batches
from repro_torch.kernels import common as kernels_common
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.serving.failpoints import FailPlan


def run(arch: str, steps: int = 100, batch: int = 8, seq: int = 64,
        ckpt_dir: str | None = None, full: bool = False,
        bloom: bool = True, log_every: int = 10, microbatch: int = 0,
        grad_compression: str = "none", seed: int = 0,
        fault_at: int = -1, learning_rate: float = 3e-3,
        bwd_impl: str | None = None, table_dtype: str | None = None,
        failpoints: str | None = None, device=None):
    """Train; returns (model, history), history one {"step", "loss",
    "step_s"} per logged step."""
    device = resolve_device(device)
    if device.type == "cuda":
        kernels_common.build()     # nvcc at first use: not in the run's wall
    cfg = (configs.get_config(arch, bloom=bloom) if full
           else configs.get_smoke_config(arch))
    if bwd_impl is not None:
        cfg = dataclasses.replace(cfg, bwd_impl=bwd_impl)
    if table_dtype is not None:
        cfg = dataclasses.replace(cfg, table_dtype=table_dtype)
    tc = TrainConfig(optimizer="adamw", learning_rate=learning_rate,
                     grad_clip_norm=1.0, steps=steps, warmup_steps=10,
                     checkpoint_every=max(steps // 4, 10),
                     microbatch=microbatch,
                     grad_compression=grad_compression)

    # data: synthetic Zipf token stream, as the reference's driver makes it
    stream = synthetic.make_token_stream(
        n_tokens=batch * (seq + 1) * max(steps, 64), vocab=cfg.vocab,
        seed=seed)
    it = BatchIterator([lm_batches(stream, batch, seq)], batch, seed=seed)

    def make_batch(arrays):
        tokens = torch.as_tensor(arrays[0]).to(device)
        b = {"tokens": tokens}
        if cfg.family in ("vlm", "audio"):
            b["embeds"] = torch.zeros(
                tokens.shape[0], max(4, seq // 4), cfg.d_model,
                dtype=getattr(torch, cfg.dtype), device=device)
        return b

    step_fn, optimizer = steps_lib.make_train_step(cfg, tc)
    model = steps_lib.init_fn_for(cfg)(seed).to(device)
    opt_state = optimizer.init({n: p.detach()
                                for n, p in model.named_parameters()})
    start_step = 0

    ckpt = Checkpointer(ckpt_dir, keep=tc.keep_checkpoints,
                        async_write=True) if ckpt_dir else None
    if ckpt:
        params = {n: p.detach() for n, p in model.named_parameters()}
        restored, rstep, extra = ckpt.restore_latest(
            {"params": params, "opt_state": opt_state})
        if restored is not None:
            with torch.no_grad():
                for name, p in restored["params"].items():
                    params[name].copy_(p)
            opt_state = restored["opt_state"]
            start_step = rstep
            if "data" in extra:
                it.restore(extra["data"])
            print(f"resumed from step {rstep}")

    plan = FailPlan.parse(failpoints)
    if fault_at >= 0:
        plan = plan.merge(FailPlan.parse(f"train_fault@{fault_at}"))
    fault_hook = plan.train_hook()

    def state():
        return {"params": dict(model.named_parameters()),
                "opt_state": opt_state}

    history = []
    t_start = time.perf_counter()
    try:
        for s in range(start_step, steps):
            if fault_hook is not None:
                fault_hook(s)
            b = make_batch(next(it))
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(model, opt_state, b)
            if log_every and (s + 1) % log_every == 0:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                history.append({"step": s + 1, "loss": loss, "step_s": dt})
                print(f"step {s+1:5d}  loss {loss:.4f}  {dt*1e3:.0f} ms",
                      flush=True)
            if ckpt and (s + 1) % tc.checkpoint_every == 0:
                ckpt.save(s + 1, state(), extra={"data": it.state()},
                          block=False)
        if ckpt:
            ckpt.save(steps, state(), extra={"data": it.state()})
    finally:
        if ckpt:
            ckpt.wait()
    wall = time.perf_counter() - t_start
    print(f"trained {steps - start_step} steps in {wall:.1f}s")
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: its smoke size)")
    ap.add_argument("--no-bloom", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="accepted and not read, as in the reference")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16"])
    ap.add_argument("--fault-at", type=int, default=-1,
                    help="raise at this step (fault-tolerance demo); "
                         "sugar for --failpoints train_fault@S")
    ap.add_argument("--failpoints", default=None,
                    help="failpoint spec (serving/failpoints.py grammar), "
                         "e.g. train_fault@7")
    ap.add_argument("--bwd-impl", default=None, choices=["dense", "csr"],
                    help="Bloom embedding backward: csr (the CSR "
                         "scatter-add, the default) or dense (the m-tile "
                         "sweep)")
    ap.add_argument("--table-dtype", default=None,
                    choices=["auto", "float32", "bfloat16", "int8",
                             "fp8_e4m3"],
                    help="Bloom embedding table storage dtype: the "
                         "forward gathers the table quantized in the "
                         "graph, the gradient is straight-through into the "
                         "f32 master (default auto: no quantization)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt, full=args.full, bloom=not args.no_bloom,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        fault_at=args.fault_at, bwd_impl=args.bwd_impl,
        table_dtype=args.table_dtype, failpoints=args.failpoints,
        device=args.device)


if __name__ == "__main__":
    main()
