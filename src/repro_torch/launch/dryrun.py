"""Multi-pod dry run: prove the distribution config is coherent without the
cards, and count one rank's step for the roofline.

For every (arch x shape) cell this module runs the port's own step (the
train step with its optimizer update, the prefill step, the decode step
with the Eq. 3 top-k recovery at ``topk=16``) for ONE rank of the
production mesh (16x16, 2x16x16 multi-pod; ``mesh.counting_mesh``), at
full width and full depth, on ``meta`` tensors: shapes and dtypes, no
storage and no arithmetic.  The parameters come from
``steps.init_fn_for``'s model class on ``meta``, each rank's shard from
``param_pspecs`` / ``opt_state_pspecs`` / ``batch_pspecs`` /
``cache_pspecs`` and ``local_shard``, the inputs from
``configs.input_specs`` / ``cache_specs``.  It records:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matmul
    FLOPs of every op, the backward's too);
  * bytes: a dispatch mode (``StepCounter``) adds every aten op's
    operand and result bytes, as an unfused eager op reads and writes
    them (a view moves none; a gather reads the rows it gathers).  A
    Bloom kernel's call is counted as its kernel's least traffic (the
    kernel module's ``min_bytes``, through ``kernels.common.run_plain``),
    not by the plain version that runs on ``meta``, whose steps the card
    never takes;
  * collectives: every call of the mesh's ``CountingTransport``, through
    ``roofline.ring_collectives``'s ring model;
  * memory: ``argument_bytes`` the exact sum of this rank's parameter,
    optimizer-state, batch and cache shards; ``temp_bytes`` the peak of
    the live ``meta`` bytes the step allocates beyond them (weakref
    finalizers on each new storage, in the same dispatch mode);
    ``output_bytes`` what the step returns; ``code_bytes`` 0.

The JAX package extrapolates its roofline from unrolled L and 2L variants
because XLA counts a loop body once.  The port counts every layer: the
``reduced`` L1 / L2 block is kept for the artifact's schema, and the
``roofline`` comes from the full-depth count (``tests/
test_torch_dryrun.py`` holds the two equal).  ``compile_s`` is the
seconds the count took.  The H100's rates are ``launch/roofline.py``'s.

Every family runs: the decode step reads its caches by their specs
(``sharding.decode_dist``), a cache whose sequence splits (whisper's 12
heads on a 16-way axis, long_500k's B = 1 over the batch axes) slice by
slice, its softmax partials merged by one all-gather that the counting
transport records.  ``zero=True`` (ZeRO-1) raises: its optimizer specs
exist, their execution does not (ROADMAP A13b item 5).  The step runs
the config's execution knobs as the card would: chunked attention and
``remat`` (a training step counts each super-block's recompute in the
backward, as the reference's HLO does; ``remat="dots"``'s
selective-checkpoint mode sits inside the counters, so an op it keeps is
counted once, where the forward ran it).  ``remat``, ``causal_skip`` and
``attn_*`` overrides change the count and are recorded with the config.
Only ``scan_layers`` and ``unroll_for_analysis`` (``XLA_ONLY_OVERRIDES``,
which size XLA's HLO and cost analysis) have no counterpart here:
``run_cell`` drops them from the config, records them under
``xla_only_overrides`` and says so.  An MoE config's
``moe_impl="dense"`` keeps every expert on the rank, which a ``model``
axis of more than one refuses, so the dry run counts such a cell with
``moe_impl="ep"`` and records it.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all              # the 32-cell grid
  python -m repro_torch.launch.dryrun --all --multi-pod --no-roofline
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPE_BY_NAME, MeshConfig, TrainConfig
from repro_torch.kernels import common
from repro_torch.launch import roofline, sharding, steps
from repro_torch.launch.mesh import counting_mesh
from repro_torch.models import transformer as tf

aten = torch.ops.aten

# the reference's XLA execution knobs, which the port has no counterpart of
XLA_ONLY_OVERRIDES = ("scan_layers", "unroll_for_analysis")
# the execution knobs the artifact records (configs/base.py)
EXECUTION_KNOBS = ("remat", "attn_impl", "attn_chunk_q", "attn_chunk_k",
                   "causal_skip", "attn_bf16_scores")
OUT_DIR = "experiments/dryrun_torch"

# ops that read the rows they gather (the index and twice the output)
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
            aten.embedding.default}
# in-place ops that write (and for the accumulating ones read) only the
# rows their source covers
_INDEXED_WRITES = {aten.index_put_.default, aten._index_put_impl_.default,
                   aten.scatter_.src, aten.scatter_.value,
                   aten.scatter_add_.default, aten.index_add_.default,
                   aten.index_copy_.default, aten.scatter_reduce_.two}


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements, but no more
    than its storage holds (a broadcast view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Counts one step's bytes and tracks its live allocations (the
    module's docstring).  ``arguments`` (any nest of tensors) are the
    step's inputs: their storages are never counted as allocated.  While
    it counts, ``kernels.common.METER`` is this counter, so a Bloom
    kernel's plain version is counted by ``kernel``."""

    def __init__(self, arguments):
        super().__init__()
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._depth = 0
        # strong references: an argument's storage id is never reused
        self._args = [t.untyped_storage() for t in _tensors(arguments)]
        self._known = {id(st) for st in self._args}
        self._alive: Dict[int, int] = {}

    def __enter__(self):
        common.METER = self
        return super().__enter__()

    def __exit__(self, *exc):
        common.METER = None
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._alive:
                continue
            n = st.nbytes()
            self._alive[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
            self.peak = max(self.peak, self.live)

    def kernel(self, name, min_bytes, fn, args, kwargs):
        """A Bloom kernel's plain version (``common.run_plain``): its ops
        go uncounted, the kernel's ``min_bytes()`` counts, and its
        outputs are allocated."""
        if self._depth:
            return fn(*args, **kwargs)
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        n = int(min_bytes())
        if callable(name):
            name = name()
        k = self.kernels.setdefault(name, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += n
        self.bytes += n
        self._track(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._depth:
            self.bytes += op_bytes(func, (args, kwargs), out)
            self._track(out)
        return out


def op_bytes(func, inputs, out) -> int:
    """The bytes one unfused op reads and writes: each distinct input
    tensor and each output once; nothing for a view (outputs that alias
    an input, nothing written) or an ``empty``; a gather's index and twice
    its output; an indexed write's index and source and the rows it
    writes; ``copy_`` its source and destination."""
    ins = list({id(t): t for t in _tensors(inputs)}.values())
    outs = _tensors(out)
    if not ins:
        return 0 if "empty" in func.__name__ else sum(map(_nbytes, outs))
    if func in _GATHERS:
        return (sum(_nbytes(t) for t in ins[1:])
                + 2 * sum(map(_nbytes, outs)))
    if func in _INDEXED_WRITES:
        rest = [t for t in ins[1:]]
        src = max((_nbytes(t) for t in rest if t.dtype == ins[0].dtype),
                  default=0)
        return sum(map(_nbytes, rest)) + src
    if func is aten.copy_.default:
        return _nbytes(ins[0]) + _nbytes(ins[1])
    in_st = {id(t.untyped_storage()) for t in ins}
    writes = func._schema.is_mutable
    if not writes and all(id(t.untyped_storage()) in in_st for t in outs):
        return 0
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def _meta_model(cfg, dist, serving: bool):
    """One rank's shard of the model on ``meta``: f32 master params for
    training, cast for compute (the serving cast) for inference."""
    with torch.device("meta"):
        model = steps.model_class_for(cfg)(cfg)
    sharding.shard_module(model, sharding.param_pspecs(cfg, model, dist),
                          dist.mesh)
    if serving:
        steps.cast_params_for_compute(model, cfg)
    return model.requires_grad_(not serving)


def step_variant(cfg, shape, dist, tc: TrainConfig):
    """(run, arguments): a thunk running one rank's step of ``shape``'s
    kind, and the step's arguments (this rank's shards)."""
    batch = configs.input_specs(cfg, shape)
    local = sharding.local_batch(batch, dist)
    if shape.kind == "train":
        model = _meta_model(cfg, dist, serving=False)
        step, optimizer = steps.make_train_step(cfg, tc, dist)
        params = {n: p.detach() for n, p in model.named_parameters()}
        opt_state = optimizer.init(params)
        return (lambda: step(model, opt_state, batch),
                (params, opt_state, local))
    model = _meta_model(cfg, dist, serving=True)
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, dist)
        return (lambda: step(model, batch["tokens"], batch.get("embeds")),
                (params, local))
    whole = configs.cache_specs(cfg, shape)
    dist = sharding.decode_dist(cfg, whole, dist, shape.global_batch)
    step = steps.make_decode_step(cfg, topk=16, device="meta", dist=dist)
    caches = sharding.shard_caches(cfg, whole, dist, shape.global_batch)
    return (lambda: step(model, batch["tokens"], caches, shape.seq_len - 1),
            (params, local, caches))


def count_step(run, arguments, transport) -> dict:
    """Run ``run()`` under the counters: its FLOPs, bytes, collectives,
    Bloom kernels and memory (the module's docstring)."""
    transport.calls.clear()
    t0 = time.perf_counter()
    counter = StepCounter(arguments)
    with FlopCounterMode(display=False) as flops, counter:
        out = run()
        out_bytes = storage_bytes(out)
        del out
    return {
        "flops_dev": float(flops.get_total_flops()),
        "bytes_dev": float(counter.bytes),
        "collectives": roofline.ring_collectives(transport.calls),
        "kernels": counter.kernels,
        "memory": {"argument_bytes": storage_bytes(arguments),
                   "output_bytes": out_bytes,
                   "temp_bytes": counter.peak,
                   "code_bytes": 0},
        "compile_s": time.perf_counter() - t0,
    }


def _reduced(cfg, n_layers: int):
    """The same config at ``n_layers`` layers."""
    return dataclasses.replace(cfg, num_layers=n_layers)


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        mc = MeshConfig(multi_pod=multi_pod)
        return counting_mesh(mc.shape, mc.axes)
    return counting_mesh(mesh_shape)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             bloom: bool = True, roofline_pass: bool = True,
             overrides=None, out_dir: str = OUT_DIR,
             mesh_shape=None, tag: str = "", zero: bool = False,
             optimizer: str = "adamw"):
    """Count one cell for one rank (the module's docstring) and write its
    artifact (the reference's keys) under ``out_dir``.  mesh_shape: an
    optional (data, model) override, e.g. (32, 8) for a model axis of 8
    (256 ranks either way)."""
    overrides = dict(overrides or {})
    xla_only = {k: overrides.pop(k) for k in list(overrides)
                if k in XLA_ONLY_OVERRIDES}
    cfg = configs.get_config(arch, bloom=bloom, **overrides)
    shape = SHAPE_BY_NAME[shape_name]
    ok, reason = configs.cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    if zero:
        raise NotImplementedError(
            "ZeRO-1: the optimizer-state specs exist (sharding."
            "opt_state_pspecs), their execution waits for ROADMAP A13b "
            "item 5")
    mesh = _mesh(multi_pod, mesh_shape)
    dist = sharding.DistContext(mesh)
    if cfg.moe is not None and dist.n_model > 1 and cfg.moe_impl == "dense":
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    if xla_only:
        print(f"{arch} {shape_name}: the XLA-only overrides {xla_only} "
              "have no counterpart in the port and change nothing",
              flush=True)
    n_dev = math.prod(mesh.sizes)
    tc = TrainConfig(optimizer=optimizer, grad_clip_norm=1.0,
                     warmup_steps=0)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(map(str, mesh.sizes)),
              "bloom": bloom, "n_devices": n_dev,
              "param_count": cfg.param_count(),
              "model_flops_global": roofline.model_flops(cfg, shape),
              "device": "H100 SXM (launch/roofline.py rates)",
              "moe_impl": cfg.moe_impl if cfg.moe is not None else None,
              "execution": {k: getattr(cfg, k) for k in EXECUTION_KNOBS},
              "xla_only_overrides": xla_only}

    def count(c):
        return count_step(*step_variant(c, shape, dist, tc), mesh.transport)

    result["full"] = count(cfg)
    if roofline_pass:
        period = tf.period_of(cfg)
        ext = {}
        for name, L in (("L1", period), ("L2", 2 * period)):
            # a config at its own depth is the full count: not recounted
            ext[name] = dict(result["full"] if L == cfg.num_layers
                             else count(_reduced(cfg, L)), layers=L)
        full = result["full"]
        flops, bytes_ = full["flops_dev"], full["bytes_dev"]
        coll = full["collectives"]["total_bytes"]
        result["reduced"] = ext
        result["roofline"] = roofline.roofline_terms(flops, bytes_, coll)
        result["roofline"]["flops_dev"] = flops
        result["roofline"]["bytes_dev"] = bytes_
        result["roofline"]["coll_bytes_dev"] = coll
        mf = result["model_flops_global"] / n_dev
        result["roofline"]["model_flops_ratio"] = (
            mf / flops if flops > 0 else 0.0)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        base_tag = tag or ("multipod" if multi_pod else "singlepod")
        suffix = "" if bloom else "__dense"
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{base_tag}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        result["artifact"] = path
    return result


def extrapolate(result: dict, key) -> float:
    """The reference's linear extrapolation of ``key(count)`` from the
    ``reduced`` L1 / L2 counts to the config's full depth."""
    ext = result["reduced"]
    a, b = key(ext["L1"]), key(ext["L2"])
    L1, L2 = ext["L1"]["layers"], ext["L2"]["layers"]
    cfg = configs.get_config(result["arch"], bloom=result["bloom"])
    per = (b - a) / (L2 - L1)
    return max(a + per * (cfg.num_layers - L1), 0.0)


def _run_one(cell, kw):
    """("OK" | "FAIL", the lines to print) of one cell."""
    arch, shape = cell
    t0 = time.perf_counter()
    try:
        res = run_cell(arch, shape, **kw)
    except Exception as e:  # noqa: BLE001 (reported, counted, exit 1)
        return "FAIL", (f"FAIL {arch} {shape}: {e}\n"
                        + traceback.format_exc().rstrip())
    took = time.perf_counter() - t0
    if "roofline" in res:
        r = res["roofline"]
        return "OK", (f"OK  {arch:18s} {shape:12s} "
                      f"compute={r['compute_s']:.4f}s "
                      f"memory={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s "
                      f"dom={r['dominant']} [{took:.0f}s]")
    mem = res.get("full", {}).get("memory", {})
    return "OK", (f"OK  {arch:18s} {shape:12s} "
                  f"temp={mem.get('temp_bytes', 0)/2**30:.2f}GiB "
                  f"args={mem.get('argument_bytes', 0)/2**30:.2f}GiB "
                  f"[{took:.0f}s]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-bloom", action="store_true")
    ap.add_argument("--no-roofline", action="store_true",
                    help="the full-depth count only (no L1 / L2 block, no "
                         "roofline)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch, shape, ok, _ in configs.all_cells():
            if ok:
                cells.append((arch, shape))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("--arch/--shape or --all required")
    kw = dict(multi_pod=args.multi_pod, bloom=not args.no_bloom,
              roofline_pass=not args.no_roofline, out_dir=args.out)

    counts = {"OK": 0, "FAIL": 0}

    def report(outcome):
        kind, text = outcome
        counts[kind] += 1
        print(text, flush=True)

    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as pool:
            for outcome in pool.map(_run_one, cells, [kw] * len(cells)):
                report(outcome)
    else:
        for cell in cells:
            report(_run_one(cell, kw))
    print(f"done: {counts['OK']}/{len(cells)} cells passed", flush=True)
    raise SystemExit(1 if counts["FAIL"] else 0)


if __name__ == "__main__":
    main()
