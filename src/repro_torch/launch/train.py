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

``--mesh DxM`` (D data shards times M model shards, e.g. 2x2) trains over
D * M ranks, which the entry point starts itself, one process each
(``spawn``: torch.multiprocessing, no ``torchrun``), exchanging over
``--transport`` (gloo, the default, or nccl; named, never switched):
each rank joins the world (``collectives.init_world``; on CUDA, gloo puts
every rank on card 0 and nccl rank r on card r), builds the mesh, and
takes its shard of the parameters that rank 0 drew or restored and
broadcast; the step is ``steps.make_train_step(cfg, tc, dist)`` on the
global batch.  A checkpoint is gathered to full tensors
(``sharding.gather_state_dict``) and written by rank 0 in the reference's
format, so a run resumes on any mesh.  ``--mesh 1x1`` (the default) is
the one-process path.  The kernels are built once, before the ranks
start.  ``run(..., zero=True)`` (ZeRO-1, as the reference's ``run_cell``
takes it; no CLI flag, as in the reference) keeps on each rank only its
slice of Adam's moments over the data axis
(``steps.make_train_step(zero=True)``); its checkpoints gather the
moments whole, so it resumes on any mesh, with or without ZeRO-1.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --full --steps 20 [--bwd-impl dense]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --mesh 2x2 --transport gloo --device cpu --steps 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --device cpu --steps 16 [--ckpt /tmp/ckpt_qwen]
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --full --steps 8
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic
from repro_torch.data.pipeline import BatchIterator, lm_batches
from repro_torch.kernels import common as kernels_common
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.serving.failpoints import FailPlan


def parse_mesh(spec: str) -> tuple:
    """"2x2" -> (2, 2): the (data, model) shape of ``--mesh``."""
    try:
        shape = tuple(int(v) for v in spec.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh wants DxM (e.g. 2x2), got {spec!r}")
    return shape


def run(arch: str, steps: int = 100, batch: int = 8, seq: int = 64,
        ckpt_dir: str | None = None, full: bool = False,
        bloom: bool = True, log_every: int = 10, microbatch: int = 0,
        grad_compression: str = "none", seed: int = 0,
        fault_at: int = -1, learning_rate: float = 3e-3,
        bwd_impl: str | None = None, table_dtype: str | None = None,
        failpoints: str | None = None, device=None, mesh: str = "1x1",
        transport: str = "gloo", moe_impl: str | None = None,
        timeout: float = 1800.0, zero: bool = False):
    """Train; returns (model, history), history one {"step", "loss",
    "step_s"} per logged step.  With ``mesh`` other than "1x1" the run
    goes over D * M ranks (the module's docstring), which must end within
    ``timeout`` seconds, and returns (None, rank 0's history); ``zero``
    (ZeRO-1) shards the moments over the data axis."""
    kw = dict(arch=arch, steps=steps, batch=batch, seq=seq,
              ckpt_dir=ckpt_dir, full=full, bloom=bloom,
              log_every=log_every, microbatch=microbatch,
              grad_compression=grad_compression, seed=seed,
              fault_at=fault_at, learning_rate=learning_rate,
              bwd_impl=bwd_impl, table_dtype=table_dtype,
              failpoints=failpoints, moe_impl=moe_impl)
    shape = parse_mesh(mesh)
    if shape == (1, 1):
        if zero:
            raise ValueError("ZeRO-1 shards the moments over the data "
                             "axis of a mesh: pass mesh DxM")
        return _train(device=resolve_device(device), **kw)
    kw["zero"] = zero
    return None, spawn(_train_rank, shape, transport, device, (kw,),
                       timeout)[0]


def _train_rank(mesh, kw):
    """One rank of ``run``: its history (rank 0 prints)."""
    return _train(dist_ctx=sharding.DistContext(mesh), device=mesh.device,
                  **kw)[1]


def _config(arch, full, bloom, bwd_impl, table_dtype, moe_impl):
    cfg = (configs.get_config(arch, bloom=bloom) if full
           else configs.get_smoke_config(arch))
    over = {k: v for k, v in (("bwd_impl", bwd_impl),
                              ("table_dtype", table_dtype),
                              ("moe_impl", moe_impl)) if v is not None}
    return dataclasses.replace(cfg, **over) if over else cfg


def _train(arch, steps, batch, seq, ckpt_dir, full, bloom, log_every,
           microbatch, grad_compression, seed, fault_at, learning_rate,
           bwd_impl, table_dtype, failpoints, moe_impl, device,
           dist_ctx=None, zero=False):
    if device.type == "cuda":
        kernels_common.build()     # nvcc at first use: not in the run's wall
    cfg = _config(arch, full, bloom, bwd_impl, table_dtype, moe_impl)
    tc = TrainConfig(optimizer="adamw", learning_rate=learning_rate,
                     grad_clip_norm=1.0, steps=steps, warmup_steps=10,
                     checkpoint_every=max(steps // 4, 10),
                     microbatch=microbatch,
                     grad_compression=grad_compression)
    lead = dist_ctx is None or dist_ctx.mesh.rank == 0

    # data: synthetic Zipf token stream, as the reference's driver makes it
    # (every rank makes the same global batches)
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

    step_fn, optimizer = steps_lib.make_train_step(cfg, tc, dist_ctx, zero)
    ckpt = Checkpointer(ckpt_dir, keep=tc.keep_checkpoints,
                        async_write=True) if ckpt_dir and lead else None
    if dist_ctx is None:
        model = steps_lib.init_fn_for(cfg)(seed).to(device)
        opt_state = optimizer.init({n: p.detach()
                                    for n, p in model.named_parameters()})
        start_step, extra = 0, {}
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
        specs = opt_specs = None
    else:
        model, opt_state, start_step, extra, specs, opt_specs = \
            parallel_state(cfg, optimizer, seed, ckpt, dist_ctx, zero=zero)
    if start_step:
        if "data" in extra:
            it.restore(extra["data"])
        if lead:
            print(f"resumed from step {start_step}")

    plan = FailPlan.parse(failpoints)
    if fault_at >= 0:
        plan = plan.merge(FailPlan.parse(f"train_fault@{fault_at}"))
    fault_hook = plan.train_hook()

    def save(step, block):
        """Every rank gathers (collectives); rank 0 writes."""
        params = dict(model.named_parameters())
        state = {"params": params, "opt_state": opt_state}
        if dist_ctx is not None:
            mesh = dist_ctx.mesh
            state = {"params": sharding.gather_state_dict(params, specs,
                                                          mesh),
                     "opt_state": sharding.gather_tree(opt_state, opt_specs,
                                                       mesh)}
        if ckpt:
            ckpt.save(step, state, extra={"data": it.state()}, block=block)

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
                if lead:
                    print(f"step {s+1:5d}  loss {loss:.4f}  "
                          f"{dt*1e3:.0f} ms", flush=True)
            if ckpt_dir and (s + 1) % tc.checkpoint_every == 0:
                save(s + 1, block=False)
        if ckpt_dir:
            save(steps, block=True)
    finally:
        if ckpt:
            ckpt.wait()
    wall = time.perf_counter() - t_start
    if lead:
        print(f"trained {steps - start_step} steps in {wall:.1f}s")
    return model, history


def parallel_state(cfg, optimizer, seed: int, ckpt, dist_ctx,
                   full_params=None, zero: bool = False):
    """(model, opt_state, start_step, extra, param specs, opt-state
    specs) of one rank: rank 0 draws the full f32 params from ``seed``
    (or takes ``full_params``, name -> tensor) or restores the newest
    checkpoint of ``ckpt`` (params, optimizer state, step and extra),
    broadcasts them, and every rank keeps its shards (``param_pspecs``,
    ``opt_state_pspecs``; with ``zero``, ZeRO-1's, each moment also
    split over the data axis: ``steps.init_opt_state``).  Without an
    ``optimizer`` (inference) the state and its specs are None."""
    mesh = dist_ctx.mesh
    device, lead = mesh.device, mesh.rank == 0
    cls = steps_lib.model_class_for(cfg)
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to_empty(device=device)
    restored, start_step, extra = None, 0, {}
    if lead:
        src = (full_params if full_params is not None else
               dict(steps_lib.init_fn_for(cfg)(seed).named_parameters()))
        src = {n: t.detach().float() for n, t in src.items()}
        if ckpt:
            src = {n: t.cpu() for n, t in src.items()}
            restored, rstep, extra = ckpt.restore_latest(
                {"params": src, "opt_state": optimizer.init(src)})
            if restored is not None:
                src, start_step = restored["params"], rstep
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(src[n])
    head = [restored is not None, start_step, extra]
    dist.broadcast_object_list(head, src=0)
    has_opt, start_step, extra = head
    for p in model.parameters():
        mesh.transport.broadcast(p.data, src=0)
    specs = sharding.param_pspecs(cfg, model, dist_ctx)
    full = {n: p.detach() for n, p in model.named_parameters()}
    opt_full = optimizer.init(full) if has_opt else None
    if has_opt:
        if lead:
            opt_full = _copy_tree(opt_full, restored["opt_state"])
        _broadcast_tree(opt_full, mesh)
    sharding.shard_module(model, specs, mesh)
    if optimizer is None:
        return model, None, start_step, extra, specs, None
    opt_state, opt_specs = steps_lib.init_opt_state(cfg, optimizer, model,
                                                    dist_ctx, zero)
    if has_opt:
        opt_state = sharding.shard_tree(opt_full, opt_specs, mesh)
    return model, opt_state, start_step, extra, specs, opt_specs


def _copy_tree(dst, src):
    if isinstance(dst, dict):
        return {k: _copy_tree(v, src[k]) for k, v in dst.items()}
    if isinstance(dst, (tuple, list)):
        return type(dst)(_copy_tree(d, s) for d, s in zip(dst, src))
    return dst.copy_(src)


def _broadcast_tree(tree, mesh):
    if isinstance(tree, dict):
        for v in tree.values():
            _broadcast_tree(v, mesh)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _broadcast_tree(v, mesh)
    else:
        mesh.transport.broadcast(tree, src=0)


def train_job(mesh, cfg, tc, params, batches, first_grads=False,
              zero=False):
    """One rank of a parallel run from given weights: ``params`` (name ->
    full f32 tensor or array, read on rank 0) trained on the global
    ``batches`` (a list of {name: array}) by ``make_train_step(cfg, tc,
    dist, zero)``.  Returns {"losses": one per step, the same on every
    rank}, and with ``first_grads`` on rank 0 {"grads": the first step's
    gradients, averaged over the batch axes and gathered whole (name ->
    numpy)}."""
    dist_ctx = sharding.DistContext(mesh)
    step, optimizer = steps_lib.make_train_step(cfg, tc, dist_ctx, zero)
    full = {n: torch.as_tensor(v) for n, v in params.items()}
    model, opt_state, _, _, specs, _ = parallel_state(
        cfg, optimizer, 0, None, dist_ctx, full, zero)
    out = {"losses": []}
    for i, b in enumerate(batches):
        batch = {k: torch.as_tensor(v).to(mesh.device) for k, v in b.items()}
        if i == 0 and first_grads:
            _, _, g = steps_lib.value_and_grad(
                model, cfg, sharding.local_batch(batch, dist_ctx), dist_ctx)
            g = sharding.gather_state_dict(
                collectives.data_mean(g, dist_ctx), specs, mesh)
            if mesh.rank == 0:
                out["grads"] = {n: t.cpu().numpy() for n, t in g.items()}
        opt_state, metrics = step(model, opt_state, batch)
        out["losses"].append(float(metrics["loss"]))
    return out


def prefill_job(mesh, cfg, params, tokens):
    """One rank of a parallel prefill from given weights (``train_job``'s
    ``params``) on the global ``tokens``: rank 0 returns
    {"last_logits": (B, m_vocab) numpy, gathered over the mesh, "aux"}."""
    dist_ctx = sharding.DistContext(mesh)
    full = {n: torch.as_tensor(v) for n, v in params.items()}
    model = parallel_state(cfg, None, 0, None, dist_ctx, full)[0]
    out = steps_lib.make_prefill_step(cfg, dist_ctx)(
        model, torch.as_tensor(tokens).to(mesh.device))
    last, aux = out["last_logits"], out["aux"]
    if dist_ctx.n_batch > 1 and dist_ctx.batch_spec_axes(
            tokens.shape[0]) is not None:
        last = torch.cat(collectives.all_gather(last, dist_ctx, "batch"))
    if mesh.rank:
        return None
    return {"last_logits": last.float().cpu().numpy(), "aux": float(aux)}


def mesh_for(mesh, shape):
    """A mesh of ``shape`` over ``mesh``'s world: ``mesh`` itself when the
    shapes agree, else ``mesh_lib.world_mesh`` on its device and
    transport (every rank must call it: a group's creation is
    collective)."""
    if tuple(shape) == mesh.sizes:
        return mesh
    return mesh_lib.world_mesh(shape, mesh.axis_names, mesh.device,
                               mesh.transport)


def run_jobs(mesh, cases) -> list:
    """Several jobs in one world: ``fn(mesh_for(mesh, shape), *args)`` for
    each case (mesh shape, fn, args): the list of this rank's results, so
    that one ``spawn`` pays the ranks' start once."""
    return [fn(mesh_for(mesh, shape), *args) for shape, fn, args in cases]


# --------------------------------------------------------------------------
# Starting the ranks
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init_method, transport, device_type, shape,
               fn, args, results):
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        device = collectives.init_world(rank, world, init_method, transport,
                                        device_type)
        mesh = mesh_lib.world_mesh(shape, ("data", "model"), device,
                                   collectives.Transport(transport))
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, shape, transport: str = "gloo", device=None, args=(),
          timeout: float = 1800.0) -> list:
    """Run ``fn(mesh, *args)`` on prod(shape) ranks, one process each
    (torch.multiprocessing, ``spawn``), over a (data, model) mesh of
    ``shape`` joined through ``transport``; returns the ranks' results
    (picklable) in rank order.  ``fn`` is a module-level function.  On
    CUDA the kernels are built here first, so that the ranks find them
    built.  A rank that fails (or a run past ``timeout`` seconds) stops
    every rank and raises with its traceback."""
    world = math.prod(shape)
    device = resolve_device(device)
    collectives.Transport(transport)
    if device.type == "cuda":
        kernels_common.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, init, transport, device.type, tuple(shape), fn, args,
        results)) for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the ranks stopped (exit codes {dead}) or ran past "
                        f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


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
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: D data shards times M model shards, one "
                         "rank each, started here (default 1x1: one "
                         "process)")
    ap.add_argument("--transport", choices=collectives.TRANSPORTS,
                    default="gloo",
                    help="the ranks' collectives: gloo (ranks may share "
                         "a card) or nccl (a card per rank)")
    ap.add_argument("--moe-impl", default=None, choices=["dense", "ep"],
                    help="MoE path: dense (every expert on the rank) or "
                         "ep (experts split over the model axis)")
    args = ap.parse_args(argv)
    run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt, full=args.full, bloom=not args.no_bloom,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        fault_at=args.fault_at, bwd_impl=args.bwd_impl,
        table_dtype=args.table_dtype, failpoints=args.failpoints,
        device=args.device, mesh=args.mesh, transport=args.transport,
        moe_impl=args.moe_impl)


if __name__ == "__main__":
    main()
