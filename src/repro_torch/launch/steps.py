"""Step builders for the training and serving paths: plain closures over a
RetrievalConfig or a ModelConfig (PyTorch runs eagerly; there is nothing
to compile).

LM training: ``make_train_step`` casts the f32 master params to the
compute dtype inside the step (differentiably), takes the loss and its
gradients (``value_and_grad``), and applies the optimizer's update to the
master params.  LM serving: ``init_fn_for`` + ``cast_params_for_compute``
make the serving model, ``make_prefill_step`` runs the prompt, and
``make_decode_step`` (the whole batch at one position) or
``make_slot_decode_step`` (a slot pool, each row at its own position) one
token (both include the paper's Eq. 3 top-k recovery, so serving cost is
end to end); ``init_caches_for`` allocates the decode caches,
``warm_bloom_caches`` pre-builds a quantized embedding table (and, for a
differentiated decode, the CSR bins of the vocab hash matrix), and
``insert_cache_slot`` writes a prefill's caches into the slot pool;
``make_sharded_insert`` and ``make_compact_pool`` write and permute the
rows of one data shard of a sharded pool (serving/sharded_pool.py).
``loss_fn_for``, ``apply_fn_for``, ``init_fn_for`` and
``init_caches_for`` dispatch on the family: the encoder-decoder
(``audio``, ``models/encdec.py``) or the decoder-only LM
(``models/transformer.py``, the ``vlm`` family's frontend among it).
Prefill takes the frontend's ``embeds`` (the ``vlm`` image embeddings
or the ``audio`` frames); decode takes tokens alone.

Under a mesh (``dist``, launch/sharding.DistContext over a world of
ranks, the model holding each rank's local shards): ``loss_fn_for``,
``value_and_grad``, ``make_train_step`` and ``make_prefill_step`` take
the context.  The train step takes the GLOBAL batch and keeps this
rank's rows (``sharding.local_batch``: split over the batch axes, which
must divide it), runs the model tensor-parallel over ``model`` (every
family, each layer split where the reference's rules split it), averages the
gradients over the batch axes (``collectives.data_mean``; with
``grad_compression="bf16"`` rounded to bf16 before the all-reduce), then
clips by the global norm over the shards (a model-sharded leaf's squares
summed over ``model``, a replicated one counted once) and updates each
rank's shards, the moments mirroring them.  With ``zero=True`` (ZeRO-1)
each moment holds only this rank's slice over the batch axes
(``init_opt_state``): the clip's norm is taken on the whole gradients as
before, the rest of the optimizer runs on the slices of the gradients
and master params, and each updated slice is all-gathered over the batch
axes into its param, so the params are the plain step's bit for bit.
The whole-batch decode step
takes the context too, carrying the caches' specs
(``sharding.decode_dist``): the global tokens, this rank's cache shards
(``sharding.cache_pspecs``: its batch rows where the batch divides the
batch axes, else every row; its kv heads where they divide the model
axis, else every kv head; its Mamba heads and channels), the logits'
columns gathered whole over ``model`` before the Eq. 3 top-k.  A cache
whose sequence splits (over ``model`` where neither the heads nor the kv
heads divide the axis; over the batch axes where the batch does not
divide them) is read slice by slice and its softmax partials merged
(models/attention.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import bloom as bloom_lib
from repro_torch.launch import collectives
from repro_torch.launch import sharding
from repro_torch.optim import optimizers as opt_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import io as io_lib
from repro_torch.models import transformer as tf
from repro_torch.train import trainer as trainer_lib


def loss_fn_for(cfg: ModelConfig, dist=None):
    """(model, batch) -> (loss, metrics): the family's objective
    (``encdec.encdec_loss_fn`` for ``audio``, else
    ``transformer.lm_loss_fn``; under ``dist``, the model's forward with
    it, on this rank's batch rows)."""
    if dist is not None:
        return lambda model, batch: model(batch, dist)
    base = (encdec_lib.encdec_loss_fn if cfg.family == "audio"
            else tf.lm_loss_fn)
    return lambda model, batch: base(model, cfg, batch)


def apply_fn_for(cfg: ModelConfig):
    """The family's forward, ``encdec.encdec_apply`` for ``audio``, else
    ``transformer.lm_apply``; both take (model, cfg, tokens, mode, caches,
    pos, embeds)."""
    return encdec_lib.encdec_apply if cfg.family == "audio" else tf.lm_apply


def model_class_for(cfg: ModelConfig):
    """The family's module: ``encdec.EncDec`` for ``audio``, else
    ``transformer.TransformerLM``; both take (cfg, generator, cast)."""
    return encdec_lib.EncDec if cfg.family == "audio" else tf.TransformerLM


def init_fn_for(cfg: ModelConfig):
    """seed -> the family's CPU f32 model drawn from
    ``torch.Generator().manual_seed(seed)``."""
    cls = model_class_for(cfg)
    return lambda seed: cls(cfg, torch.Generator().manual_seed(seed))


def cast_params_for_compute(model: torch.nn.Module, cfg: ModelConfig):
    """One-shot f32 -> ``cfg.dtype`` cast of the params the reference
    casts (``transformer.compute_cast``: every block param, an
    ``EncDec``'s encoder and decoder blocks alike, the embedding and
    ``frontend_proj``; the 1-D final and encoder norms stay f32), for
    serving.  In place (the serving model keeps no f32 copy); returns
    ``model``."""
    tf.cast_for_compute(model, "", getattr(torch, cfg.dtype))
    return model


def value_and_grad(model: torch.nn.Module, cfg: ModelConfig, batch,
                   dist=None):
    """(loss, metrics, grads) of the model's objective (its ``forward``:
    ``lm_loss_fn`` or ``encdec_loss_fn``) on ``batch`` at the
    model's f32 master params, with the reference's compute cast taken
    inside, differentiably: each cast param is a ``.to(dtype)`` of its
    master, so its gradient flows back in f32.  ``grads`` maps each param
    name to a tensor in the master's dtype.  Under ``dist`` the params
    are this rank's shards, ``batch`` its rows, and the loss and grads
    this rank's (not yet averaged over the batch axes)."""
    dt = getattr(torch, cfg.dtype)
    params = dict(model.named_parameters())
    compute = {n: p.to(dt) if tf.compute_cast(n, p) else p
               for n, p in params.items()}
    loss, metrics = torch.func.functional_call(model, compute, (batch,),
                                               {"dist": dist})
    grads = torch.autograd.grad(loss, list(params.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, dist=None,
                    zero: bool = False):
    """(step, optimizer): ``step(model, opt_state, batch) -> (opt_state,
    metrics)`` takes the loss and gradients (``value_and_grad``), runs the
    optimizer and writes ``(p + u).to(p.dtype)`` into the model's master
    params in place (the reference returns new params; updating in place
    keeps one f32 copy on the device).  ``tc.microbatch`` is not read,
    as in the reference's LM step.

    Under ``dist`` (the module's docstring) ``batch`` is the global batch
    and the model and optimizer state hold this rank's shards; the
    metrics are averaged over the batch axes, the same on every rank.
    ``zero`` (ZeRO-1, under ``dist``): the optimizer state is
    ``init_opt_state(..., zero=True)``'s, each moment this rank's slice
    over the batch axes, and the update runs on the slices (the module's
    docstring)."""
    if zero and dist is None:
        raise ValueError("ZeRO-1 shards the moments over a mesh's batch "
                         "axes: pass dist")
    # from the first step: the model-sharded param names and ZeRO-1's
    # slice specs; on each step, the clip's norm
    split = {}
    if dist is None:
        optimizer = trainer_lib.make_optimizer(tc)
    else:
        optimizer = trainer_lib.make_optimizer(
            tc, norm_fn=lambda g: split["norm"])

    def step(model, opt_state, batch):
        if dist is not None:
            B = next(iter(batch.values())).shape[0]
            if B % dist.n_batch:
                raise ValueError(f"the global batch {B} must divide the "
                                 f"batch axes ({dist.n_batch} shards)")
            batch = sharding.local_batch(batch, dist)
            if "names" not in split:
                split["names"] = (sharding.model_sharded(
                    sharding.param_pspecs(cfg, model, dist))
                    if dist.n_model > 1 else set())
                split["zero"] = (zero_specs(cfg, optimizer, model, dist)
                                 if zero else {})
        loss, metrics, grads = value_and_grad(model, cfg, batch, dist)
        zspecs = {}
        if dist is not None:
            grads = collectives.data_mean(grads, dist, tc.grad_compression)
            loss, metrics = _batch_mean((loss, metrics), dist)
            if tc.grad_clip_norm and tc.grad_clip_norm > 0:
                # on the whole gradients, before ZeRO-1 slices them
                split["norm"] = opt_lib.global_norm(
                    grads, split["names"],
                    lambda t: collectives.all_reduce_sum(t, dist))
            zspecs = split["zero"]
        params = dict(model.named_parameters())
        mine = zero_slices(params, zspecs, dist)
        opt_state = trainer_lib.apply_gradients(
            mine, zero_slices(grads, zspecs, dist), optimizer, opt_state)
        with torch.no_grad():
            for n, spec in zspecs.items():
                params[n].copy_(sharding.gather_leaf(mine[n], spec,
                                                     dist.mesh))
        return opt_state, {"loss": loss, **metrics}

    return step, optimizer


def zero_specs(cfg: ModelConfig, optimizer, model: torch.nn.Module,
               dist) -> Dict[str, sharding.P]:
    """ZeRO-1's split of this rank's model shards: name -> the spec of
    the slice over the batch axes (``sharding.zero_dim``, ``zero_spec``
    on the param's own spec) that its moments hold, for every param whose
    moments split.  None split where the batch axes are 1, nor under
    adafactor, whose factored moments stay whole
    (``sharding.factored``)."""
    local = {n: p.detach() for n, p in model.named_parameters()}
    meta = optimizer.init({n: torch.empty_like(t, device="meta")
                           for n, t in local.items()})
    if dist.n_batch == 1 or sharding.factored(meta, set(local)):
        return {}
    specs = sharding.param_pspecs(cfg, model, dist)
    dims = {n: sharding.zero_dim(specs[n], t.shape, dist.n_batch)
            for n, t in local.items()}
    return {n: sharding.zero_spec(sharding.P(), d, dist) for n, d in dims.items()
            if d is not None}


def init_opt_state(cfg: ModelConfig, optimizer, model: torch.nn.Module,
                   dist, zero: bool = False):
    """(this rank's fresh optimizer state, its specs) for the model's
    shards; with ``zero`` (ZeRO-1) each split moment is made at its slice
    over the batch axes (``zero_specs``), never whole."""
    local = {n: p.detach() for n, p in model.named_parameters()}
    zspecs = zero_specs(cfg, optimizer, model, dist) if zero else {}
    state = optimizer.init(zero_slices(local, zspecs, dist))
    # a rank's shapes serve as the full ones: ``zero_dim`` reads only the
    # dims that a param's spec leaves whole
    return state, sharding.opt_state_pspecs(
        state, sharding.param_pspecs(cfg, model, dist),
        zero_dist=dist if zspecs else None,
        params_shapes={n: tuple(t.shape) for n, t in local.items()})


def zero_slices(tensors, zspecs, dist):
    """name -> this rank's slice (``sharding.local_shard``, a copy) of
    each tensor that ``zspecs`` (``zero_specs``) splits, the others as
    they are."""
    return {n: t if n not in zspecs else
            sharding.local_shard(t.detach(), zspecs[n], dist.mesh)
            for n, t in tensors.items()}


def _batch_mean(tree, dist):
    """Every scalar of a (loss, metrics) pair averaged over the batch
    axes."""
    if dist.n_batch == 1:
        return tree
    loss, metrics = tree
    vals = torch.stack([loss.float(), *(v.float() for v in metrics.values())])
    vals = collectives.all_reduce_sum(vals, dist, "batch") / dist.n_batch
    return vals[0], dict(zip(metrics, vals[1:]))


def make_prefill_step(cfg: ModelConfig, dist=None):
    """(model, tokens (B, S), embeds (B, S_emb, D) or None) ->
    {last_logits (B, m_vocab), caches}: the inference prefill, with the
    frontend's embeddings (``vlm``: ahead of the tokens; ``audio``: the
    encoder's frames).

    Under ``dist`` the inputs are global and this rank takes its batch
    rows (``sharding.local_batch``; replicated when they do not divide
    the batch axes); ``last_logits`` are this rank's rows, whole over m
    (a sharded vocab's columns all-gathered over ``model``), the caches
    its rows, kv heads and Mamba heads, over the whole prompt (a split
    sequence is cut by ``serve.pad_caches_to``), and ``aux`` the MoE
    layers' load-balance loss."""
    apply_fn = apply_fn_for(cfg)

    @torch.inference_mode()
    def step(model, tokens, embeds=None):
        kw = {}
        if dist is not None:
            split = dist.batch_spec_axes(tokens.shape[0]) is not None
            inputs = sharding.local_batch(
                {"tokens": tokens} if embeds is None
                else {"tokens": tokens, "embeds": embeds}, dist)
            tokens, embeds = inputs["tokens"], inputs.get("embeds")
            kw["dist"] = (dist if split else
                          dataclasses.replace(dist, rows_split=False))
        out = apply_fn(model, cfg, tokens, mode="prefill", embeds=embeds,
                       **kw)
        last = out["logits"][:, -1]
        if dist is not None and io_lib.vocab_lo(last.shape[-1], cfg,
                                                dist) is not None:
            last = torch.cat(collectives.all_gather(last, dist), dim=-1)
        return {"last_logits": last, "caches": out["caches"],
                "aux": out["aux"]}

    return step


def make_decode_step(cfg: ModelConfig, topk: int, device, dist=None):
    """Whole-batch decode step on ``device`` (the static path).

    (model, token (B, 1), caches, pos int) ->
        {logits (B, 1, m_vocab), caches, topk_scores, topk_ids}

    The slot step (``make_slot_decode_step``) with every row at the one
    sequence offset ``pos`` and no ``active`` mask, so the Eq. 3 recovery
    takes the decode-top-k kernel's dense grid on CUDA.

    Under ``dist`` (the module's docstring; it must carry the caches'
    specs, ``sharding.decode_dist``) ``token`` is the global batch and
    ``caches`` this rank's shards; the outputs are this rank's rows (B /
    the batch shards, or every row where B does not divide them), every
    rank of a model group holding the same ids and scores.
    """
    slot_step = make_slot_decode_step(cfg, topk, device, dist)
    # a batch that does not divide the batch axes: every rank holds every
    # row, as the prefill's (so an MoE routes them as the whole batch)
    whole_step = (None if dist is None else make_slot_decode_step(
        cfg, topk, device, dataclasses.replace(dist, rows_split=False)))

    def step(model, token, caches, pos):
        run = slot_step
        if dist is not None:
            if dist.cache_specs is None:
                raise ValueError("the decode step under a mesh reads its "
                                 "caches by their specs: pass "
                                 "sharding.decode_dist(...)")
            if dist.batch_spec_axes(token.shape[0]) is None:
                run = whole_step
            token = sharding.local_batch({"tokens": token}, dist)["tokens"]
        rows = torch.full((token.shape[0],), int(pos), dtype=torch.long,
                          device=token.device)
        return run(model, token, caches, rows, None)

    return step


def make_slot_decode_step(cfg: ModelConfig, topk: int, device, dist=None):
    """Continuous-batching decode step over a slot pool on ``device``.

    (model, token (B, 1), caches, pos (B,), active (B,) or None) ->
        {logits (B, 1, m_vocab), caches, topk_scores, topk_ids}

    Every slot decodes at its own sequence offset ``pos``; ``active``
    masks the Eq. 3 recovery so retired slots never leak tokens (and the
    decode kernel skips them).  The vocab hash matrix is built here, once
    per (spec, device), not in the first step — for the legacy
    ``table_dtype="auto"`` path only: a quantized decode of an on-the-fly
    spec rehashes in the kernel.

    ``dist`` (``make_decode_step``'s): the rows are this rank's, the
    caches its shards, and a vocab sharded over ``model`` is gathered
    whole before the recovery, since Eq. 3 sums logp over all k hash
    columns; the returned logits are whole.  A sharded pool's rank
    (serving/sharded_pool.py) passes its host's rows with their own
    ``pos`` and ``active``, so the decode-top-k kernel's row-skipping
    grid sees this rank's live rows; its pool's rows divide ``data``
    (``sharding.slot_pool_pspecs`` refuses a pool whose rows do not).
    """
    spec = io_lib.vocab_spec(cfg)
    if spec is not None and (io_lib.resolved_table_dtype(cfg) is None
                             or not spec.on_the_fly):
        bloom_lib.cached_hash_matrix(spec, device)
    apply_fn = apply_fn_for(cfg)
    kw = {} if dist is None else {"dist": dist}

    @torch.inference_mode()
    def step(model, token, caches, pos, active):
        out = apply_fn(model, cfg, token, mode="decode", caches=caches,
                       pos=pos, **kw)
        logits = out["logits"]
        if kw and io_lib.vocab_lo(logits.shape[-1], cfg, dist) is not None:
            logits = torch.cat(collectives.all_gather(logits, dist), dim=-1)
        scores, ids = io_lib.recover_topk(cfg, logits[:, 0], topk=topk,
                                          active=active)
        return {"logits": logits, "caches": out["caches"],
                "topk_scores": scores, "topk_ids": ids}

    return step


def warm_bloom_caches(cfg: ModelConfig, model: torch.nn.Module,
                      decode_grad: bool = False) -> None:
    """Pre-build the per-spec Bloom caches the hot path reads, so the first
    step does not pay for them (the reference's
    ``train.trainer.warm_bloom_caches``): with a ``cfg.table_dtype`` other
    than "auto", a serving model's quantized embedding table
    (``core.bloom.cached_quantized_table``); with ``decode_grad`` (a
    workload that differentiates the Eq. 3 decode through
    ``ops.bloom_decode``) and ``cfg.bwd_impl == "csr"``, the hash matrix
    and its CSR bins (``core.bloom.cached_decode_bins``) on the model's
    device, and on a CUDA device the 16-bit copy of the matrix that the
    decode kernel reads (``core.bloom.cached_packed_hash_matrix``).  A
    no-op without Bloom IO."""
    spec = io_lib.vocab_spec(cfg)
    if spec is None:
        return
    td = io_lib.resolved_table_dtype(cfg)
    if td is not None:
        bloom_lib.cached_quantized_table(spec, model.embed, td)
    if decode_grad and cfg.bwd_impl == "csr":
        bloom_lib.cached_decode_bins(spec, model.embed.device)
    if decode_grad and model.embed.is_cuda:
        bloom_lib.cached_packed_hash_matrix(spec, model.embed.device)


# the cache leaves with a sequence (position or frame) axis, axis 1
SEQ_LEAVES = ("k", "v", "cross_k", "cross_v")


@torch.inference_mode()
def insert_cache_slot(pool, caches_small, slot: int, seq_lo=None):
    """Write a prefill's caches into rows [slot, slot + B) of the pool, in
    place, leaf by leaf by its role; returns the pool.  Attention k/v
    (prefill (B, S, KV, hd), pool (n_slots, T, KV, hd)) go to positions
    [0, S); the Mamba leaves (ssm state and conv history) and the
    encoder-decoder's cross k/v (``cross_k`` / ``cross_v``, one row per
    encoder frame, which decode never grows) have no growing sequence
    axis and are replaced whole.  One request is B = 1; a
    whole-batch prefill at slot 0 fills the pool
    (``serve.pad_caches_to``).  Stale k/v past S from an earlier occupant
    are never read: decode attends only to positions <= the slot's offset
    and writes each position before reaching it.

    ``seq_lo`` (per layer, {leaf: position}) places a pool whose leaf
    holds one slice of a split sequence: the pool's position 0 is the
    prefill's ``seq_lo``, and the leaf takes the prefill's positions that
    fall in its slice (a leaf missing from it starts at 0)."""
    for i, (buf, small) in enumerate(zip(pool, caches_small)):
        for name, s in small.items():
            rows = buf[name][slot:slot + s.shape[0]]
            if name in SEQ_LEAVES:
                lo = 0 if seq_lo is None else seq_lo[i].get(name, 0)
                s = s[:, lo:lo + rows.shape[1]]
            if name in ("k", "v"):
                rows = rows[:, :s.shape[1]]
            rows.copy_(s)
    return pool


def local_rows(dist, slots_per_shard: int) -> Tuple[int, int]:
    """(the first slot of a sharded pool's rows, how many): every slot on
    one device; over a world of ranks the rank's own data shard's."""
    if dist.mesh.distributed:
        return dist.batch_index * slots_per_shard, slots_per_shard
    return 0, dist.n_batch * slots_per_shard


def _check_pool_layout(pool, pool_specs, dist, slots_per_shard: int):
    """The pool's leaves must be the layout's, slot axis first and as
    many rows long as ``local_rows`` says."""
    rows = local_rows(dist, slots_per_shard)[1]
    if [set(layer) for layer in pool] != [set(s) for s in pool_specs]:
        raise ValueError("pool leaves do not match the pool layout")
    for layer, specs in zip(pool, pool_specs):
        for name, buf in layer.items():
            if buf.shape[0] != rows or len(specs[name]) != buf.dim():
                raise ValueError(
                    f"pool leaf {name} {tuple(buf.shape)}: want slot axis "
                    f"0 of {rows} rows and spec {specs[name]}")


def _shard_rows(pool, lo: int, hi: int):
    """Views of rows [lo, hi) of every pool leaf (the same storage)."""
    return [{name: buf[lo:hi] for name, buf in layer.items()}
            for layer in pool]


def make_sharded_insert(pool_specs, dist, slots_per_shard: int):
    """``insert_cache_slot`` into a data-axis-sharded slot pool.

    The pool's slot axis is split over ``dist``'s data shards
    (``sharding.slot_pool_pspecs``): shard h owns rows ``[h * sps,
    (h + 1) * sps)``.  ``insert(pool, caches_small, slot, host)`` moves a
    B = 1 prefill's caches from the prefill worker's device to the pool's
    device (the device-to-device transfer of the reference's replicated
    broadcast), asserts that ``slot`` lies in the range of ``host``, the
    shard executing the admission, and writes them through
    ``insert_cache_slot``'s role rules into views of that shard's rows
    only: every other row of the pool is untouched and no leaf is
    reallocated.  On one device the pool holds every shard's rows; over
    a world of ranks (``dist.mesh.distributed``) it holds this rank's
    shard's ``sps`` rows and its ``model`` part of each leaf, ``host``
    must be this rank's data shard, and the caches are the owner's
    prefill's, already split over ``model`` as the pool is.  Returns the
    pool."""
    n_slots = dist.n_batch * slots_per_shard
    first, _ = local_rows(dist, slots_per_shard)

    @torch.inference_mode()
    def insert(pool, caches_small, slot: int, host: int):
        _check_pool_layout(pool, pool_specs, dist, slots_per_shard)
        slot, host = int(slot), int(host)
        lo = host * slots_per_shard
        rows = {s.shape[0] for layer in caches_small for s in layer.values()}
        assert rows == {1}, f"a sharded insert takes one request, got {rows}"
        assert 0 <= slot < n_slots and slot // slots_per_shard == host, (
            f"slot {slot} outside shard {host}'s rows [{lo}, "
            f"{lo + slots_per_shard})")
        if dist.mesh.distributed:
            assert host == dist.batch_index, (
                f"slot {slot} of shard {host} is outside this rank's "
                f"shard {dist.batch_index}")
        device = pool[0][next(iter(pool[0]))].device
        small = [{name: s.to(device) for name, s in layer.items()}
                 for layer in caches_small]
        insert_cache_slot(_shard_rows(pool, lo - first,
                                      lo - first + slots_per_shard),
                          small, slot - lo)
        return pool

    return insert


def make_compact_pool(pool_specs, dist, slots_per_shard: int):
    """Slot-compaction remap of the sharded pool.

    ``compact(pool, perm)`` applies the control plane's (n_slots,) gather
    permutation (``perm[new_slot] = old_slot``) to every leaf's slot axis,
    in place, within each data shard's rows: a shard whose window of
    ``perm`` is the identity is not touched.  ``control.plan_compaction``
    promises that no entry crosses a shard boundary; one that does
    raises, before any row moves.  Over a world of ranks the pool is this
    rank's shard, and only its window of ``perm`` applies.  Returns the
    pool."""
    n_slots = dist.n_batch * slots_per_shard
    first, rows = local_rows(dist, slots_per_shard)

    @torch.inference_mode()
    def compact(pool, perm):
        _check_pool_layout(pool, pool_specs, dist, slots_per_shard)
        perm = [int(p) for p in perm]
        if sorted(perm) != list(range(n_slots)):
            raise ValueError(f"not a permutation of {n_slots} slots: {perm}")
        for new, old in enumerate(perm):
            if new // slots_per_shard != old // slots_per_shard:
                raise ValueError(
                    f"compaction moves slot {old} to {new}, across the "
                    f"boundary of shards of {slots_per_shard} slots")
        device = pool[0][next(iter(pool[0]))].device
        for lo in range(first, first + rows, slots_per_shard):
            local = [p - lo for p in perm[lo:lo + slots_per_shard]]
            if local == list(range(slots_per_shard)):
                continue
            idx = torch.tensor(local, dtype=torch.long, device=device)
            for layer in _shard_rows(pool, lo - first,
                                     lo - first + slots_per_shard):
                for buf in layer.values():
                    buf.copy_(buf.index_select(0, idx))
        return pool

    return compact


def init_caches_for(cfg: ModelConfig, shape: ShapeConfig):
    """``(dtype=..., device=...) -> caches``: zeroed decode caches of
    ``shape.global_batch`` rows of ``shape.seq_len`` positions
    (``transformer.init_lm_cache``; for ``audio``
    ``encdec.init_encdec_cache`` with the cross k/v of whisper's 1,500
    frames, as the reference's)."""
    if cfg.family == "audio":
        return functools.partial(encdec_lib.init_encdec_cache, cfg,
                                 shape.global_batch, shape.seq_len,
                                 encdec_lib.ENC_LEN)
    return functools.partial(tf.init_lm_cache, cfg, shape.global_batch,
                             shape.seq_len)


def make_retrieval_prefill_step(rcfg):
    """One-shot retrieval prefill.

    (tower, items (B, c_max) int, -1-padded) -> (B, m) tower logits:
    Bloom-encode the item set (core.bloom.encode, Eq. 1, on-the-fly
    hashing) and run the FF tower (models/recommender.FFTower).  The
    payload a ``oneshot`` slot holds is this logits row.
    """
    spec = rcfg.spec()

    @torch.inference_mode()
    def step(tower, items):
        return tower(bloom_lib.encode(spec, items))       # (B, m)

    return step


def make_retrieval_decode_step(rcfg, device):
    """The single recover step of a ``oneshot`` slot pool on ``device``.

    (pool (n_slots, m) logits, active (n_slots,)) -> (scores, ids) of
    shape (n_slots, topk): log_softmax then the occupancy-aware fused
    Eq. 3 top-k over the d-item catalog (io.recover_topk_spec) — never
    materializing (n_slots, d) scores.  ``active`` masks retired slots to
    scores=-inf / ids=0, and the kernel does no work for them.
    ``rcfg.table_dtype`` other than "auto" stores the logp rows narrow and
    rehashes in the kernel; only the "auto" path reads the hash matrix,
    built here once per (spec, device), not in the first step.
    """
    spec = rcfg.spec()
    td = None if rcfg.table_dtype == "auto" else rcfg.table_dtype
    if td is None:
        bloom_lib.cached_hash_matrix(spec, device)

    @torch.inference_mode()
    def step(pool, active):
        return io_lib.recover_topk_spec(spec, pool, topk=rcfg.topk,
                                        active=active, table_dtype=td)

    return step
