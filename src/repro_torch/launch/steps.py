"""Step builders for the training and serving paths: plain closures over a
RetrievalConfig or a ModelConfig (PyTorch runs eagerly; there is nothing
to compile).

LM training: ``make_train_step`` casts the f32 master params to the
compute dtype inside the step (differentiably), takes the loss and its
gradients (``value_and_grad``), and applies the optimizer's update to the
master params.  LM serving: ``init_fn_for`` + ``cast_params_for_compute``
make the serving model, ``make_prefill_step`` / ``make_slot_decode_step``
run it (the decode step includes the paper's Eq. 3 top-k recovery, so
serving cost is end to end), ``warm_bloom_caches`` pre-builds a quantized
embedding table (and, for a differentiated decode, the CSR bins of the
vocab hash matrix), and ``insert_cache_slot`` writes a prefill's caches into
the slot pool.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import bloom as bloom_lib
from repro_torch.models import io as io_lib
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as trainer_lib


def init_fn_for(cfg: ModelConfig):
    """seed -> a CPU f32 ``TransformerLM`` drawn from
    ``torch.Generator().manual_seed(seed)``."""
    return lambda seed: tf.TransformerLM(
        cfg, torch.Generator().manual_seed(seed))


def _cast_for_compute(name: str, p: torch.Tensor) -> bool:
    """The params the reference casts to the compute dtype: every floating
    param of ndim >= 2 of its layer-STACKED tree, in which each block param
    carries a leading layer axis.  So every block param (the per-layer
    RMSNorm gains and the (H, hd) QKV biases too) and the embedding go to
    the compute dtype, and only the final norm's 1-D gain stays f32."""
    return p.is_floating_point() and (p.ndim >= 2
                                      or name.startswith("blocks."))


def cast_params_for_compute(model: torch.nn.Module, cfg: ModelConfig):
    """One-shot f32 -> ``cfg.dtype`` cast of the params the reference
    casts (``_cast_for_compute``), for serving.  In place (the serving
    model keeps no f32 copy); returns ``model``."""
    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if _cast_for_compute(name, p):
                p.data = p.data.to(dt)
    return model


def value_and_grad(model: tf.TransformerLM, cfg: ModelConfig, batch):
    """(loss, metrics, grads) of ``lm_loss_fn`` on ``batch`` at the
    model's f32 master params, with the reference's compute cast taken
    inside, differentiably: each cast param is a ``.to(dtype)`` of its
    master, so its gradient flows back in f32.  ``grads`` maps each param
    name to a tensor in the master's dtype."""
    dt = getattr(torch, cfg.dtype)
    params = dict(model.named_parameters())
    compute = {n: p.to(dt) if _cast_for_compute(n, p) else p
               for n, p in params.items()}
    loss, metrics = torch.func.functional_call(model, compute, (batch,))
    grads = torch.autograd.grad(loss, list(params.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(step, optimizer): ``step(model, opt_state, batch) -> (opt_state,
    metrics)`` takes the loss and gradients (``value_and_grad``), runs the
    optimizer and writes ``(p + u).to(p.dtype)`` into the model's master
    params in place (the reference returns new params; updating in place
    keeps one f32 copy on the device).  ``tc.microbatch`` is not read,
    as in the reference's LM step."""
    optimizer = trainer_lib.make_optimizer(tc)

    def step(model, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, cfg, batch)
        params = {n: p.detach() for n, p in model.named_parameters()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        new = opt_lib.apply_updates(params, updates)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(new[name])
        return opt_state, {"loss": loss, **metrics}

    return step, optimizer


def make_prefill_step(cfg: ModelConfig):
    """(model, tokens (B, S)) -> {last_logits (B, m_vocab), caches}: the
    inference prefill."""

    @torch.inference_mode()
    def step(model, tokens):
        out = tf.lm_apply(model, cfg, tokens, mode="prefill")
        return {"last_logits": out["logits"][:, -1],
                "caches": out["caches"]}

    return step


def make_slot_decode_step(cfg: ModelConfig, topk: int, device):
    """Continuous-batching decode step over a slot pool on ``device``.

    (model, token (B, 1), caches, pos (B,), active (B,)) ->
        {caches, topk_scores, topk_ids}

    Every slot decodes at its own sequence offset ``pos``; ``active``
    masks the Eq. 3 recovery so retired slots never leak tokens (and the
    decode kernel skips them).  The vocab hash matrix is built here, once
    per (spec, device), not in the first step — for the legacy
    ``table_dtype="auto"`` path only: a quantized decode of an on-the-fly
    spec rehashes in the kernel.
    """
    spec = io_lib.vocab_spec(cfg)
    if spec is not None and (io_lib.resolved_table_dtype(cfg) is None
                             or not spec.on_the_fly):
        bloom_lib.cached_hash_matrix(spec, device)

    @torch.inference_mode()
    def step(model, token, caches, pos, active):
        out = tf.lm_apply(model, cfg, token, mode="decode", caches=caches,
                          pos=pos)
        scores, ids = io_lib.recover_topk(cfg, out["logits"][:, 0],
                                          topk=topk, active=active)
        return {"caches": out["caches"], "topk_scores": scores,
                "topk_ids": ids}

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


@torch.inference_mode()
def insert_cache_slot(pool, caches_small, slot: int):
    """Write one request's prefill caches (per layer (1, S, KV, hd)) into
    slot ``slot`` of the pool (per layer (n_slots, T, KV, hd)) at positions
    [0, S), in place; returns the pool.  Stale entries past S from an
    earlier occupant are never read: decode attends only to positions
    <= the slot's offset and writes each position before reaching it."""
    for buf, small in zip(pool, caches_small):
        for name in ("k", "v"):
            s = small[name]
            buf[name][slot, :s.shape[1]] = s[0].to(buf[name].dtype)
    return pool


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
