"""Serving entry point: thin CLI over the continuous-batching engine and
the whole-batch path.

The default mode builds a seeded Poisson workload (serving/loadgen.py) and
serves it through ``serving.engine.Engine`` (``run_continuous``): requests
are admitted into freed cache slots every decode step and retired on
per-slot stop conditions.  Every prefill and decode step embeds its tokens
through the Bloom embedding (the ``bloom_embed`` CUDA kernel on a GPU) and
recovers the next token by the paper's Eq. 3 top-k over the original
vocab (the ``bloom_decode_topk`` CUDA kernel).  ``--static`` is the
whole-batch path (``run``): ``--batch`` seeded prompts of one length,
prefilled together, then greedy decoding at one shared position until
``--gen`` tokens.  ``--table-dtype`` (int8, fp8_e4m3, bfloat16, float32)
stores the Bloom tables narrow: the embedding table is quantized once at
set-up and gathered by the quantized ``bloom_embed`` variant, and every
Eq. 3 decode quantizes its logp rows and rehashes the vocab in the kernel.
The encoder-decoder (``audio``, whisper-small) and the vision-frontend
(``vlm``, pixtral-12b) archs serve only by ``--static``, as in the
reference: their prefill carries the frontend's embeddings (zeros of
``max(4, prompt_len // 4)`` rows in ``run``), which the engine does not
schedule.

``--sharded`` serves per-host Poisson streams (``--requests`` each)
through ``serving.sharded_pool.ShardedEngine`` (``run_sharded``):
``--hosts`` simulated hosts (default: the device count), each a data
shard of ``--slots-per-host`` slots of one pool on the device, admission
by the replicated control plane over ``--transport`` (``sim`` gossip, or
``collective``, the padded exchange) after ``--gossip-delay`` steps,
and slot compaction above ``--compact-threshold``; ``kill_host``
failpoints need it.  ``--sharded --mesh DxM`` puts each of D hosts on
its own M rank processes, which the entry point starts (``train.spawn``)
and joins over ``--backend`` (gloo, the default: ranks may share a card
or run on the CPU; nccl: a card per rank, raising with fewer): each rank
holds its host's slot rows and its share of their kv heads, Mamba heads
and channels, and ``collective`` all-gathers the deltas over the
ranks.

``--mode retrieval`` serves one-shot Bloom top-k retrieval requests (Zipf
item lookups over a configs/retrieval.py catalog preset) through
``serving.retrieval.RetrievalEngine`` — the same slot loop, so
``--failpoints`` and the overload flags (``--deadline-slack`` /
``--max-queue-depth``) apply there too.

``--static --mesh DxM`` serves the whole batch over D * M ranks, one
process each, which the entry point starts itself (``train.spawn``, as
``launch/train.py --mesh`` does), exchanging over ``--transport`` (gloo,
the default there, or nccl): rank 0 draws (or loads) the weights, every
rank takes its shards (``sharding.shard_module``), and each runs
``make_prefill_step(cfg, dist)`` and ``make_decode_step(cfg, topk,
device, dist)``: tensor parallel over ``model`` (every family), the
batch rows split over ``data`` where they divide it, else replicated and
the decode cache's sequence split over it; rank 0 prints the tokens.
``--mesh 1x1`` (the default) is the one-process path.

Weights are random, drawn from ``--seed`` (``build_model``, the
reference's ``_setup``): on the CPU by the port's own init, on CUDA on the
card, so the two devices serve different weights for one seed.
``--static --ckpt DIR`` serves the params of the newest checkpoint under
DIR instead (``launch/train.py``'s format).  It runs on CUDA unless
``--device cpu`` is given (smoke size unless ``--full``), and raises when
CUDA is asked for and absent.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --full --slots 8 --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --full --static --batch 4 --prompt-len 32 --gen 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --full --static --mesh 2x2 --transport gloo --batch 4 --gen 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --device cpu --static --mesh 1x2 --batch 2 --prompt-len 8 --gen 5
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-moe-16b --full --static --batch 4 --gen 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --full --layers 8 --static --batch 4 --gen 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --full --static --batch 4 --prompt-len 32 --gen 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
      --device cpu --static --batch 2 --prompt-len 8 --gen 5
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --device cpu --slots 3 --requests 10 --topk 4 [--table-dtype int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --device cpu --sharded --hosts 8 --slots-per-host 2 \\
      --transport collective --compact-threshold 0.25
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --device cpu --sharded --mesh 2x2 --slots-per-host 2 \\
      --transport collective --compact-threshold 0.25
  PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \\
      --retrieval-config smoke --device cpu --requests 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.kernels import common as kernels_common
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import collectives
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import io as io_lib
from repro_torch.models import transformer as tf
from repro_torch.serving import retrieval as retrieval_lib
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.engine import Engine, mean_latency
from repro_torch.serving.failpoints import FailPlan
from repro_torch.serving.loadgen import (LoadSpec, RetrievalLoadSpec,
                                         make_workload, retrieval_workload,
                                         sharded_workload)
from repro_torch.serving.sharded_pool import ShardedEngine


def _overload_policy(deadline_slack, max_queue_depth):
    """CLI knobs -> optional AdmissionPolicy: either flag alone activates
    the policy (deadline shedding needs workload deadlines; the ladder
    runs with its default thresholds)."""
    if deadline_slack is None and max_queue_depth is None:
        return None
    return AdmissionPolicy(max_queue_depth=max_queue_depth)


def _tag_deadlines(requests, deadline_slack):
    if deadline_slack is not None:
        for r in requests:
            r.deadline_step = r.arrival_step + deadline_slack
    return requests


def _print_policy(stats):
    if stats.rejects:
        print(f"rejected {stats.rejects} requests "
              f"(prefill attempts exhausted)")
    if stats.sheds or stats.degrades:
        print(f"overload policy: {stats.sheds} shed, "
              f"{stats.degrades} degrade transitions")


def build_model(cfg, seed: int, device):
    """The serving model on ``device``: random weights drawn there from a
    generator of that device seeded with ``seed``, each block cast to the
    compute dtype (``transformer.compute_cast``) as soon as it is drawn
    (``TransformerLM(cast=True)``, or ``EncDec`` for the ``audio``
    family), so neither the host nor the card ever holds the whole model
    in f32: the peak is the cast model plus one f32 block.  The draws and
    the cast params are the same as a whole f32 model cast afterwards
    (``cast_params_for_compute``).  On the CPU this
    is the port's init (``steps.init_fn_for``); the card's generator
    draws other weights."""
    device = torch.device(device)
    with device:
        model = steps_lib.model_class_for(cfg)(
            cfg, torch.Generator(device).manual_seed(seed), cast=True)
    return model.eval().requires_grad_(False)


def load_params(ckpt_dir: str) -> dict:
    """name -> tensor: the params of the newest readable checkpoint under
    ``ckpt_dir`` (``launch/train.py``'s, the reference's on-disk format
    with the port's param names)."""
    ck = Checkpointer(ckpt_dir)
    for step in reversed(ck.all_steps()):
        try:
            flat, _ = ck.read(step)
        except (OSError, KeyError, ValueError, EOFError):
            continue
        return {k.split("/", 1)[1]: torch.from_numpy(v)
                for k, v in flat.items() if k.startswith("params/")}
    raise FileNotFoundError(f"no readable checkpoint under {ckpt_dir}")


def model_from_params(cfg, params, device):
    """The serving model on ``device`` from full params (name -> tensor),
    cast for compute (``cast_params_for_compute``)."""
    with torch.device("meta"):
        model = steps_lib.model_class_for(cfg)(cfg)
    model = model.to_empty(device=torch.device(device))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    steps_lib.cast_params_for_compute(model, cfg)
    return model.eval().requires_grad_(False)


def _config(arch: str, full: bool, table_dtype: str | None = None,
            layers: int | None = None, moe_impl: str | None = None):
    over = {} if table_dtype is None else {"table_dtype": table_dtype}
    if layers is not None:
        over["num_layers"] = layers
    if moe_impl is not None:
        over["moe_impl"] = moe_impl
    return (configs.get_config(arch, **over) if full
            else configs.get_smoke_config(arch, **over))


def _setup(arch: str, full: bool, table_dtype, seed: int, device,
           layers: int | None = None):
    """(device, cfg, serving model) for ``run`` and ``run_continuous``:
    the kernels are built first on a card (nvcc at first use), so the
    build is not in a run's wall.  ``layers`` cuts the depth (a model
    that one card cannot hold whole)."""
    device = resolve_device(device)
    if device.type == "cuda":
        kernels_common.build()
    cfg = _config(arch, full, table_dtype, layers)
    return device, cfg, build_model(cfg, seed, device)


def pad_caches_to(caches_small, caches_template, dist=None):
    """Place prefill caches (length S_p) into preallocated max-length
    buffers: the whole-batch case (slot 0, every row) of the engine's
    slot-indexed ``steps.insert_cache_slot``.  Under ``dist`` carrying
    the caches' specs (``sharding.decode_dist``) the template is this
    rank's shards: where a leaf's sequence splits (``dist.seq_shard``),
    the rank keeps the prefill's positions that fall in its slice, the
    ``vlm`` prefix's among them."""
    seq_lo = None
    if dist is not None and dist.cache_specs is not None:
        seq_lo = [{name: seq.index * buf[name].shape[1]
                   for name in steps_lib.SEQ_LEAVES if name in buf
                   and (seq := dist.seq_shard(i, name)) is not None}
                  for i, buf in enumerate(caches_template)]
    return steps_lib.insert_cache_slot(caches_template, caches_small, 0,
                                       seq_lo)


def decode_caches(cfg, batch: int, prompt_len: int, gen: int,
                  embeds: torch.Tensor | None, device,
                  dtype=torch.bfloat16):
    """(the zeroed decode-cache pool, the first decode position) of a
    whole-batch generation of ``gen`` tokens after a ``prompt_len``-token
    prefill with the frontend's ``embeds`` (B, S_emb, D) or None.  A
    ``vlm`` prefix takes S_emb cache positions ahead of the prompt, so
    decoding starts at S_emb + prompt_len.  (The reference's ``run``
    decodes at ``prompt_len``: its first step overwrites a prompt token's
    k/v and masks out the last S_emb - 1 of them.)  The ``audio`` family's
    self-attention caches the decoder tokens alone, and its cross k/v
    hold the S_emb frames.  The caches hold ``dtype``."""
    if cfg.family == "audio":
        return encdec_lib.init_encdec_cache(
            cfg, batch, prompt_len + gen, embeds.shape[1], dtype=dtype,
            device=device), prompt_len
    n_prefix = prompt_len + (0 if embeds is None else embeds.shape[1])
    return tf.init_lm_cache(cfg, batch, n_prefix + gen, dtype=dtype,
                            device=device), n_prefix


def batch_whole(x: torch.Tensor, dist, batch: int) -> torch.Tensor:
    """Every batch shard's rows of ``x``, in order, of a ``batch``-row
    global batch (``x`` itself without a batch axis of more than one, or
    where ``batch`` does not divide it: every rank holds every row)."""
    if dist is None or dist.n_batch == 1 or batch % dist.n_batch:
        return x
    return torch.cat(collectives.all_gather(x, dist, "batch"))


def generate(cfg, model, prompts: np.ndarray, gen: int, topk: int,
             embeds: torch.Tensor | None = None, dist=None, on_step=None,
             cache_dtype=torch.bfloat16):
    """Whole-batch greedy generation on a built model: prefill ``prompts``
    (B, S) together with the frontend's ``embeds`` (B, S_emb, D), if any,
    place the caches into buffers of ``decode_caches`` (``pad_caches_to``),
    recover the first token from the last prefill logits, then decode
    ``gen - 1`` steps, every row at position n + t, n the first decode
    position (S, or S_emb + S behind a ``vlm`` prefix;
    ``make_decode_step``).  Returns (ids (B, gen) int32 numpy, prefill
    seconds, decode seconds); each window ends with the device
    synchronised.  ``on_step(t, out)`` sees each decode step's output;
    the caches hold ``cache_dtype`` (bf16, as the reference's).

    Under ``dist`` the model holds this rank's shards: the caches are its
    shards (``sharding.shard_caches``; a split sequence its slice), each
    step's tokens are gathered over the batch axes for the next (where
    the rows split), and every rank returns the whole batch's ids."""
    device = model.embed.device
    B, S = prompts.shape
    kw = {} if dist is None else {"dist": dist}
    prefill = steps_lib.make_prefill_step(cfg, **kw)
    if dist is None:
        template, n_prefix = decode_caches(cfg, B, S, gen, embeds, device,
                                           cache_dtype)
    else:
        template, n_prefix = decode_caches(cfg, B, S, gen, embeds, "meta",
                                           cache_dtype)
        dist = kw["dist"] = sharding.decode_dist(cfg, template, dist, B)
        template = [{k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                     for k, v in layer.items()}
                    for layer in sharding.shard_caches(cfg, template, dist,
                                                       B)]
    decode = steps_lib.make_decode_step(cfg, topk, device, **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    pre = prefill(model, torch.as_tensor(prompts, device=device), embeds)
    caches = pad_caches_to(pre["caches"], template, dist)
    sync()
    t_prefill = time.perf_counter() - t0

    with torch.inference_mode():
        _, ids = io_lib.recover_topk(cfg, pre["last_logits"], topk=topk)
    token = batch_whole(ids[:, :1], dist, B)
    generated = [token.cpu()]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        out = decode(model, token, caches, n_prefix + t)
        if on_step is not None:
            on_step(t, out)
        caches = out["caches"]
        token = batch_whole(out["topk_ids"][:, :1], dist, B)
        generated.append(token.cpu())
    sync()
    t_decode = time.perf_counter() - t0
    return torch.cat(generated, 1).numpy(), t_prefill, t_decode


def rank_model(cfg, dist_ctx, params, seed: int = 0):
    """This rank's serving model under ``dist_ctx``: rank 0's full
    ``params`` (name -> tensor or array; None: the port's init from
    ``seed``) broadcast and sharded (``train.parallel_state``), then cast
    for compute."""
    full = (None if params is None else
            {n: torch.as_tensor(v) for n, v in params.items()})
    model = train_lib.parallel_state(cfg, None, seed, None, dist_ctx,
                                     full)[0]
    steps_lib.cast_params_for_compute(model, cfg)
    return model.eval().requires_grad_(False)


def decode_job(mesh, cfg, params, prompts: np.ndarray, gen: int,
               topk: int, cache_dtype=torch.bfloat16, embeds=None):
    """One rank of a whole-batch generation over ``mesh`` from given
    weights (``params``: name -> full f32 tensor or array, read on rank
    0) on the global ``prompts`` and, for the ``vlm`` and ``audio``
    families, the frontend's global ``embeds`` (B, S_emb, D) array
    (``generate`` under the mesh's context).  Rank 0 returns {"ids" (B,
    gen), and per decode step "logits" (B, 1, m_vocab), "topk_ids",
    "topk_scores" (B, topk)}, numpy, the batch rows gathered; the other
    ranks None."""
    dist_ctx = sharding.DistContext(mesh)
    model = rank_model(cfg, dist_ctx, params)
    steps = []

    def keep(t, out):
        rows = {k: batch_whole(out[k], dist_ctx, len(prompts)).cpu()
                for k in ("logits", "topk_ids", "topk_scores")}
        steps.append({k: (v.float() if v.is_floating_point() else v).numpy()
                      for k, v in rows.items()})

    if embeds is not None:
        embeds = torch.as_tensor(embeds).to(mesh.device,
                                            getattr(torch, cfg.dtype))
    ids, _, _ = generate(cfg, model, prompts, gen, topk, embeds,
                         dist=dist_ctx, on_step=keep, cache_dtype=cache_dtype)
    if mesh.rank:
        return None
    return {"ids": ids, **{k: np.stack([s[k] for s in steps])
                           for k in ("logits", "topk_ids", "topk_scores")}}


def run(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
        topk: int = 8, seed: int = 0, full: bool = False,
        table_dtype: str | None = None, device=None,
        layers: int | None = None, mesh: str = "1x1",
        transport: str = "gloo", ckpt: str | None = None,
        moe_impl: str | None = None, timeout: float = 1800.0):
    """Static whole-batch serving (``--static``): ``batch`` seeded prompts
    of ``prompt_len`` tokens, ``gen`` greedy tokens each (``generate``),
    with the depth cut to ``layers`` if given.  The ``vlm`` and ``audio``
    families get zero embeddings (frames) of ``max(4, prompt_len // 4)``
    rows, as in the reference.  Prints the prefill and decode times and
    the first sequence's ids; returns the (batch, gen) ids.  ``mesh``
    other than "1x1" serves over D * M ranks (the module's docstring),
    which must end within ``timeout`` seconds; ``ckpt`` serves the newest
    checkpoint's params; ``moe_impl`` overrides the config's."""
    kw = dict(arch=arch, batch=batch, prompt_len=prompt_len, gen=gen,
              topk=topk, seed=seed, full=full, table_dtype=table_dtype,
              layers=layers, ckpt=ckpt, moe_impl=moe_impl)
    shape = train_lib.parse_mesh(mesh)
    if shape == (1, 1):
        return _run(device=resolve_device(device), **kw)
    return train_lib.spawn(_run_rank, shape, transport, device, (kw,),
                           timeout)[0]


def _run_rank(mesh, kw):
    """One rank of ``run`` over a mesh: its (batch, gen) ids."""
    return _run(device=mesh.device, dist=sharding.DistContext(mesh), **kw)


def _run(arch, batch, prompt_len, gen, topk, seed, full, table_dtype,
         layers, ckpt, moe_impl, device, dist=None):
    lead = dist is None or dist.mesh.rank == 0
    if device.type == "cuda":
        kernels_common.build()
    cfg = _config(arch, full, table_dtype, layers, moe_impl)
    if dist is None:
        model = (build_model(cfg, seed, device) if ckpt is None
                 else model_from_params(cfg, load_params(ckpt), device))
    else:
        params = None
        if lead:
            params = (load_params(ckpt) if ckpt is not None else dict(
                build_model(cfg, seed, device).named_parameters()))
        model = rank_model(cfg, dist, params, seed)
    steps_lib.warm_bloom_caches(cfg, model)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len),
                           dtype=np.int32)
    embeds = None
    if cfg.family in ("vlm", "audio"):
        embeds = torch.zeros(batch, max(4, prompt_len // 4), cfg.d_model,
                             dtype=getattr(torch, cfg.dtype), device=device)
    ids, t_prefill, t_decode = generate(cfg, model, prompts, gen, topk,
                                        embeds, dist)
    if not lead:
        return ids
    where = ("" if dist is None else
             f", mesh {'x'.join(map(str, dist.mesh.sizes))} over "
             f"{dist.mesh.transport.name}")
    print(f"whole-batch serving ({cfg.name} {cfg.num_layers}L d_model "
          f"{cfg.d_model}, table_dtype {cfg.table_dtype}, {device}{where}"
          + ("" if embeds is None else
             f", {embeds.shape[1]} zero {cfg.frontend} embeddings") + ")")
    print(f"prefill {prompt_len} toks x{batch}: {t_prefill * 1e3:.0f} ms")
    print(f"decode  {gen - 1} steps: {t_decode * 1e3:.0f} ms "
          f"({(gen - 1) * batch / max(t_decode, 1e-9):.0f} tok/s)")
    print("generated ids (first seq):", ids[0].tolist())
    return ids


def run_continuous(arch: str, slots: int = 4, requests: int = 16,
                   rate: float = 1.0, prompt_len: int = 32, gen: int = 16,
                   topk: int = 8, seed: int = 0, full: bool = False,
                   eos_id: int | None = None, prefill_workers: int = 1,
                   failpoints: str | None = None,
                   deadline_slack: int | None = None,
                   max_queue_depth: int | None = None,
                   table_dtype: str | None = None, device=None):
    """Serve a seeded Poisson workload by continuous batching, with the
    Bloom tables stored as ``table_dtype`` (default: the config's,
    "auto").  The archs the Engine does not serve (``Engine.supports``)
    exit before any model is built."""
    if not Engine.supports(_config(arch, full, table_dtype)):
        raise SystemExit(
            f"{arch}: enc-dec / frontend-stub archs serve via --static")
    device, cfg, model = _setup(arch, full, table_dtype, seed, device)
    spec = LoadSpec(
        n_requests=requests, vocab=cfg.vocab, rate=rate,
        prompt_lens=(max(prompt_len // 2, 2), prompt_len),
        gen_lens=(max(gen // 4, 1), gen // 2 or 1, gen), seed=seed)
    workload = _tag_deadlines(make_workload(spec), deadline_slack)
    max_len = max(r.prompt_len + r.max_gen for r in workload)

    engine = Engine(cfg, model, n_slots=slots, max_len=max_len, topk=topk,
                    eos_id=eos_id, prefill_workers=prefill_workers,
                    failpoints=FailPlan.parse(failpoints),
                    admission_policy=_overload_policy(deadline_slack,
                                                      max_queue_depth))
    results, stats = engine.run(workload)
    _print_policy(stats)
    row = stats.as_row()
    print(f"served {len(results)} requests on {slots} slots "
          f"(continuous, {cfg.name} {cfg.num_layers}L d_model "
          f"{cfg.d_model}, table_dtype {cfg.table_dtype}, {device}): "
          f"{row['decode_steps']} decode steps, "
          f"utilization {row['utilization']:.2f}, "
          f"mean latency {mean_latency(results):.1f} steps")
    print(f"wall {stats.wall_s * 1e3:.0f} ms "
          f"({stats.tokens_out / max(stats.wall_s, 1e-9):.0f} tok/s)")
    for r in list(results.values())[:4]:
        print(f"  req {r.rid}: arrive {r.arrival_step} admit "
              f"{r.admitted_step} finish {r.finish_step} "
              f"tokens {r.tokens[:8]}{'...' if len(r.tokens) > 8 else ''}")
    return results, stats


def run_sharded(arch: str, slots_per_host: int = 1, requests: int = 8,
                rate: float = 1.0, prompt_len: int = 32, gen: int = 16,
                topk: int = 8, seed: int = 0, full: bool = False,
                eos_id: int | None = None, gossip_delay: int = 1,
                transport: str = "sim", prefill_workers: int = 1,
                compact_threshold: float | None = None,
                table_dtype: str | None = None,
                failpoints: str | None = None,
                deadline_slack: int | None = None,
                max_queue_depth: int | None = None,
                hosts: int | None = None, device=None, mesh: str = "1x1",
                backend: str = "gloo", timeout: float = 1800.0):
    """Data-axis-sharded serving over per-host arrival streams
    (``--sharded``; serving/sharded_pool.py).  ``requests`` is PER HOST.
    With ``mesh`` "1x1" (the default) ``hosts`` simulated hosts (default:
    the device count, as the reference's mesh of every device) are data
    shards of ``slots_per_host`` slots of one pool on ``device``.  With
    ``mesh`` "DxM" the entry point starts D * M rank processes
    (``train.spawn``) joined over ``backend`` (gloo, ranks may share a
    card; nccl, a card per rank): D hosts, each host's slot rows on its
    own M ranks, split over ``model``, from weights rank 0 draws; every
    rank runs the control plane, rank 0 prints and returns.  Defaults
    (sim transport, one prefill worker, no compaction) are the
    transported pool at its plainest.  ``failpoints`` replays a
    deterministic failure schedule (serving/failpoints.py grammar) against
    the run, e.g. ``kill_host:1@3``: survivors reclaim the dead host's
    slots and finish every request.  Returns (results, stats)."""
    kw = dict(arch=arch, slots_per_host=slots_per_host, requests=requests,
              rate=rate, prompt_len=prompt_len, gen=gen, topk=topk,
              seed=seed, full=full, eos_id=eos_id,
              gossip_delay=gossip_delay, transport=transport,
              prefill_workers=prefill_workers,
              compact_threshold=compact_threshold, table_dtype=table_dtype,
              failpoints=failpoints, deadline_slack=deadline_slack,
              max_queue_depth=max_queue_depth)
    if not Engine.supports(_config(arch, full, table_dtype)):
        raise SystemExit(
            f"{arch}: enc-dec / frontend-stub archs serve via --static")
    shape = train_lib.parse_mesh(mesh)
    if shape == (1, 1):
        return _sharded(device=resolve_device(device), hosts=hosts, **kw)
    if hosts not in (None, shape[0]):
        raise ValueError(f"--hosts {hosts} with --mesh {mesh}: the mesh's "
                         f"data axis is the hosts ({shape[0]})")
    return train_lib.spawn(_sharded_rank, shape, backend, device, (kw,),
                           timeout)[0]


def _sharded_rank(mesh, kw):
    """One rank of ``run_sharded`` over a mesh: rank 0's (results,
    stats), the other ranks' None."""
    out = _sharded(device=mesh.device, hosts=mesh.shape["data"],
                   model_parallel=mesh.shape["model"], world=mesh.transport,
                   **kw)
    return out if mesh.rank == 0 else None


def _sharded(arch, slots_per_host, requests, rate, prompt_len, gen, topk,
             seed, full, eos_id, gossip_delay, transport, prefill_workers,
             compact_threshold, table_dtype, failpoints, deadline_slack,
             max_queue_depth, device, hosts=None, model_parallel=1,
             world=None):
    """``run_sharded`` on one device (``world`` None), or one rank of a
    world whose collectives ``world`` (launch/collectives.Transport)
    carries: rank 0 draws the weights, every rank holds its shard."""
    if world is None:
        device, cfg, model = _setup(arch, full, table_dtype, seed, device)
        mesh = make_serving_mesh(hosts, device=device)
    else:
        mesh = make_serving_mesh(hosts, model_parallel, device, world)
        cfg = _config(arch, full, table_dtype)
        params = (dict(_setup(arch, full, table_dtype, seed, device)[2]
                       .named_parameters()) if mesh.rank == 0 else None)
        model = rank_model(cfg, sharding.DistContext(mesh), params, seed)
        del params
    n_hosts = mesh.shape["data"]
    spec = LoadSpec(
        n_requests=requests, vocab=cfg.vocab, rate=rate,
        prompt_lens=(max(prompt_len // 2, 2), prompt_len),
        gen_lens=(max(gen // 4, 1), gen // 2 or 1, gen), seed=seed)
    per_host = sharded_workload(spec, n_hosts)
    for reqs in per_host:
        _tag_deadlines(reqs, deadline_slack)
    max_len = max(r.prompt_len + r.max_gen
                  for reqs in per_host for r in reqs)
    engine = ShardedEngine(cfg, model, mesh=mesh,
                           slots_per_host=slots_per_host, max_len=max_len,
                           topk=topk, eos_id=eos_id,
                           gossip_delay=gossip_delay, transport=transport,
                           prefill_workers=prefill_workers,
                           compact_threshold=compact_threshold,
                           failpoints=FailPlan.parse(failpoints),
                           admission_policy=_overload_policy(
                               deadline_slack, max_queue_depth))
    results, stats = engine.run(per_host)
    if mesh.rank:
        return results, stats
    row = stats.as_row()
    where = ("" if not mesh.distributed else
             f", mesh {'x'.join(map(str, mesh.sizes))} over "
             f"{mesh.transport.name}")
    print(f"served {len(results)} requests on {n_hosts} hosts x "
          f"{slots_per_host} slots (gossip_delay={gossip_delay}, "
          f"transport={transport}, prefill_workers={prefill_workers}, "
          f"compact={compact_threshold}; {cfg.name} {cfg.num_layers}L "
          f"d_model {cfg.d_model}, table_dtype {cfg.table_dtype}, "
          f"{device}{where}): {row['decode_steps']} decode steps, "
          f"{row['compactions']} compactions, "
          f"utilization {row['utilization']:.2f}, "
          f"mean latency {mean_latency(results):.1f} steps")
    if failpoints:
        print(f"failpoints {failpoints!r}: {stats.host_downs} host_downs, "
              f"{stats.requeued} requeued, {stats.rejects} rejects")
    if stats.sheds or stats.degrades:
        print(f"overload policy: {stats.sheds} shed, "
              f"{stats.degrades} degrade transitions")
    print(f"wall {stats.wall_s * 1e3:.0f} ms "
          f"({stats.tokens_out / max(stats.wall_s, 1e-9):.0f} tok/s)")
    return results, stats


def run_retrieval(preset: str = "smoke", slots: int = 4,
                  requests: int = 16, rate: float = 2.0, seed: int = 0,
                  prefill_workers: int = 1, failpoints: str | None = None,
                  deadline_slack: int | None = None,
                  max_queue_depth: int | None = None, device=None):
    """One-shot Bloom retrieval serving (--mode retrieval): Zipf item
    lookups from ``loadgen.retrieval_workload`` through RetrievalEngine."""
    device = resolve_device(device)
    rcfg = configs.get_retrieval_config(preset)
    spec = RetrievalLoadSpec(n_requests=requests, catalog=rcfg.d,
                             c_max=rcfg.c_max, rate=rate, seed=seed)
    workload = _tag_deadlines(retrieval_workload(spec), deadline_slack)
    params = retrieval_lib.init_retrieval_params(rcfg, device=device)
    engine = retrieval_lib.RetrievalEngine(
        rcfg, params, n_slots=slots, prefill_workers=prefill_workers,
        failpoints=FailPlan.parse(failpoints),
        admission_policy=_overload_policy(deadline_slack, max_queue_depth))
    results, stats = engine.run(workload)

    row = stats.as_row()
    served = [r for r in results.values() if r.done and not r.shed]
    print(f"served {len(served)}/{len(results)} retrieval requests on "
          f"{slots} slots over a d={rcfg.d:,} catalog ({preset}, {device}): "
          f"{row['decode_steps']} decode steps, "
          f"utilization {row['utilization']:.2f}, "
          f"mean latency {mean_latency(results):.1f} steps")
    _print_policy(stats)
    if rcfg.d <= retrieval_lib.EVAL_MAX_CATALOG and served:
        metrics = retrieval_lib.evaluate_retrieval(rcfg, params, served)
        print(f"offline ranking vs held-out targets: "
              f"map {metrics['map']:.4f}, rr {metrics['rr']:.4f} "
              f"over {metrics['n_evaluated']} requests")
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("lm", "retrieval"), default="lm",
                    help="'lm' = token generation (default); 'retrieval' "
                         "= one-shot Bloom top-k over an item catalog")
    ap.add_argument("--retrieval-config",
                    choices=sorted(configs.RETRIEVAL_CONFIGS),
                    default="smoke",
                    help="configs/retrieval.py preset (--mode retrieval)")
    ap.add_argument("--arch", default=None, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: its smoke size)")
    ap.add_argument("--layers", type=int, default=None,
                    help="--static path: cut the depth to this many "
                         "layers (a whole number of layer-pattern "
                         "periods), for a model that one card cannot hold "
                         "whole")
    ap.add_argument("--static", action="store_true",
                    help="the whole-batch path (A/B baseline): --batch "
                         "prompts prefilled together, decoded at one "
                         "position")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size (--static path)")
    ap.add_argument("--slots", type=int, default=4,
                    help="cache-pool slots (continuous path)")
    ap.add_argument("--requests", type=int, default=16,
                    help="workload size (continuous path)")
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrivals per decode step (default 1.0, "
                         "2.0 for --mode retrieval)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a slot early on this token id")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="prefill-pool size")
    ap.add_argument("--failpoints", default=None,
                    help="deterministic fault schedule "
                         "(serving/failpoints.py grammar), e.g. "
                         "'kill_host:1@3,fail_prefill:2:3,surge:3@1'; "
                         "host kills need --sharded")
    ap.add_argument("--deadline-slack", type=int, default=None,
                    help="tag every request with deadline = arrival + "
                         "SLACK and enable the admission policy")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="bound the visible queue; excess arrivals are "
                         "shed (enables the admission policy)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--sharded", action="store_true",
                    help="data-axis-sharded pool: one host per data "
                         "shard, all simulated on the one device, or "
                         "with --mesh DxM each on its own M ranks")
    ap.add_argument("--hosts", type=int, default=None,
                    help="simulated hosts of --sharded on one device "
                         "(default: the device count)")
    ap.add_argument("--slots-per-host", type=int, default=1,
                    help="cache-pool slots per host shard (--sharded)")
    ap.add_argument("--gossip-delay", type=int, default=1,
                    help="steps before arrivals/releases become globally "
                         "visible (--sharded)")
    ap.add_argument("--transport",
                    choices=("sim", "collective") + collectives.TRANSPORTS,
                    default=None,
                    help="--sharded: the control-plane delta transport, "
                         "'sim' = in-process gossip (default) or "
                         "'collective' = fixed-size padded exchange "
                         "(gathered on the device, or all-gathered over "
                         "the ranks of --mesh); --static --mesh: the "
                         "ranks' collectives, gloo (default; ranks may "
                         "share a card) or nccl (a card per rank)")
    ap.add_argument("--backend", choices=collectives.TRANSPORTS,
                    default=None,
                    help="--sharded --mesh: the ranks' collectives, gloo "
                         "(default; ranks may share a card) or nccl (a "
                         "card per rank)")
    ap.add_argument("--mesh", default="1x1",
                    help="--static or --sharded: DxM, D data shards "
                         "(--sharded: hosts) times M model shards, one "
                         "rank each, started here (default 1x1: one "
                         "process)")
    ap.add_argument("--ckpt", default=None,
                    help="--static: serve the params of the newest "
                         "checkpoint under this directory (launch/"
                         "train.py's) instead of drawing them")
    ap.add_argument("--moe-impl", default=None, choices=["dense", "ep"],
                    help="--static: the MoE path, dense (every expert on "
                         "the rank) or ep (experts split over the model "
                         "axis)")
    ap.add_argument("--compact-threshold", type=float, default=None,
                    help="per-host fragmentation (dead-slot fraction "
                         "below the highest live slot) above which the "
                         "slot pool compacts; default off (--sharded)")
    ap.add_argument("--table-dtype", default=None,
                    help="Bloom table storage dtype of LM serving: auto "
                         "(default), float32, bfloat16, int8 or fp8_e4m3 "
                         "(not read by --mode retrieval, as in the "
                         "reference)")
    args = ap.parse_args(argv)
    common = dict(slots=args.slots, requests=args.requests, seed=args.seed,
                  prefill_workers=args.prefill_workers,
                  failpoints=args.failpoints,
                  deadline_slack=args.deadline_slack,
                  max_queue_depth=args.max_queue_depth, device=args.device)
    meshed = train_lib.parse_mesh(args.mesh) != (1, 1)
    if meshed and not (args.static or args.sharded):
        ap.error("--mesh serves the whole-batch path (--static) or the "
                 "sharded pool (--sharded)")
    if (args.ckpt or args.moe_impl) and not args.static:
        ap.error("--ckpt and --moe-impl serve the whole-batch path: add "
                 "--static")
    if args.transport in collectives.TRANSPORTS and (
            args.sharded or not meshed):
        ap.error(f"--transport {args.transport} joins the ranks of "
                 "--static --mesh (--sharded --mesh: --backend)")
    if args.transport in ("sim", "collective") and meshed \
            and not args.sharded:
        ap.error("--static --mesh exchanges over gloo or nccl")
    if args.backend is not None and not (args.sharded and meshed):
        ap.error("--backend joins the ranks of --sharded --mesh")
    if FailPlan.parse(args.failpoints).kill_steps() and not args.sharded:
        raise SystemExit("kill_host failpoints need --sharded: only the "
                         "sharded pool has hosts to kill")
    if args.mode == "retrieval":
        if args.static or args.sharded:
            raise SystemExit("--mode retrieval is its own serve path: "
                             "drop --static/--sharded (the retrieval "
                             "pool is single-host)")
        if args.transport not in (None, "sim"):
            raise SystemExit("--mode retrieval has no control-plane "
                             "transport: the pool is single-host")
        run_retrieval(args.retrieval_config,
                      rate=2.0 if args.rate is None else args.rate, **common)
        return
    if args.arch is None:
        ap.error("--arch is required with --mode lm")
    if args.layers is not None and not args.static:
        ap.error("--layers cuts the depth of the --static path only")
    if args.static:
        run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
            gen=args.gen, topk=args.topk, seed=args.seed, full=args.full,
            table_dtype=args.table_dtype, device=args.device,
            layers=args.layers, mesh=args.mesh,
            transport=args.transport or "gloo", ckpt=args.ckpt,
            moe_impl=args.moe_impl)
        return
    if args.sharded:
        run_sharded(args.arch, slots_per_host=args.slots_per_host,
                    requests=args.requests,
                    rate=1.0 if args.rate is None else args.rate,
                    prompt_len=args.prompt_len, gen=args.gen,
                    topk=args.topk, seed=args.seed, full=args.full,
                    eos_id=args.eos_id, gossip_delay=args.gossip_delay,
                    transport=args.transport or "sim",
                    prefill_workers=args.prefill_workers,
                    compact_threshold=args.compact_threshold,
                    table_dtype=args.table_dtype,
                    failpoints=args.failpoints,
                    deadline_slack=args.deadline_slack,
                    max_queue_depth=args.max_queue_depth,
                    hosts=args.hosts, device=args.device, mesh=args.mesh,
                    backend=args.backend or "gloo")
        return
    run_continuous(args.arch, rate=1.0 if args.rate is None else args.rate,
                   prompt_len=args.prompt_len, gen=args.gen, topk=args.topk,
                   full=args.full, eos_id=args.eos_id,
                   table_dtype=args.table_dtype, **common)

if __name__ == "__main__":
    main()
