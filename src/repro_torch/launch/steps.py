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
``insert_cache_slot`` writes a prefill's caches into the slot pool.
``loss_fn_for`` and ``apply_fn_for`` give the family's objective and
forward; the encoder-decoder family (``audio``) is not ported.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import bloom as bloom_lib
from repro_torch.models import io as io_lib
from repro_torch.models import transformer as tf
from repro_torch.train import trainer as trainer_lib


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family (audio) is not ported "
            "yet (ROADMAP A12 item 6)")


def loss_fn_for(cfg: ModelConfig):
    """(model, batch) -> (loss, metrics): the LM objective
    (``transformer.lm_loss_fn``)."""
    _check_family(cfg)
    return lambda model, batch: tf.lm_loss_fn(model, cfg, batch)


def apply_fn_for(cfg: ModelConfig):
    """The family's forward, ``transformer.lm_apply``."""
    _check_family(cfg)
    return tf.lm_apply


def init_fn_for(cfg: ModelConfig):
    """seed -> a CPU f32 ``TransformerLM`` drawn from
    ``torch.Generator().manual_seed(seed)``."""
    return lambda seed: tf.TransformerLM(
        cfg, torch.Generator().manual_seed(seed))


def cast_params_for_compute(model: torch.nn.Module, cfg: ModelConfig):
    """One-shot f32 -> ``cfg.dtype`` cast of the params the reference
    casts (``transformer.compute_cast``: every block param and the
    embedding; the final norm's 1-D gain stays f32), for serving.  In
    place (the serving model keeps no f32 copy); returns ``model``."""
    tf.cast_for_compute(model, "", getattr(torch, cfg.dtype))
    return model


def value_and_grad(model: tf.TransformerLM, cfg: ModelConfig, batch):
    """(loss, metrics, grads) of ``lm_loss_fn`` on ``batch`` at the
    model's f32 master params, with the reference's compute cast taken
    inside, differentiably: each cast param is a ``.to(dtype)`` of its
    master, so its gradient flows back in f32.  ``grads`` maps each param
    name to a tensor in the master's dtype."""
    dt = getattr(torch, cfg.dtype)
    params = dict(model.named_parameters())
    compute = {n: p.to(dt) if tf.compute_cast(n, p) else p
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
        opt_state = trainer_lib.apply_gradients(
            dict(model.named_parameters()), grads, optimizer, opt_state)
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


def make_decode_step(cfg: ModelConfig, topk: int, device):
    """Whole-batch decode step on ``device`` (the static path).

    (model, token (B, 1), caches, pos int) ->
        {logits (B, 1, m_vocab), caches, topk_scores, topk_ids}

    The slot step (``make_slot_decode_step``) with every row at the one
    sequence offset ``pos`` and no ``active`` mask, so the Eq. 3 recovery
    takes the decode-top-k kernel's dense grid on CUDA.
    """
    slot_step = make_slot_decode_step(cfg, topk, device)

    def step(model, token, caches, pos):
        rows = torch.full((token.shape[0],), int(pos), dtype=torch.long,
                          device=token.device)
        return slot_step(model, token, caches, rows, None)

    return step


def make_slot_decode_step(cfg: ModelConfig, topk: int, device):
    """Continuous-batching decode step over a slot pool on ``device``.

    (model, token (B, 1), caches, pos (B,), active (B,) or None) ->
        {logits (B, 1, m_vocab), caches, topk_scores, topk_ids}

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
        return {"logits": out["logits"], "caches": out["caches"],
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


@torch.inference_mode()
def insert_cache_slot(pool, caches_small, slot: int):
    """Write a prefill's caches into rows [slot, slot + B) of the pool, in
    place, leaf by leaf by its role; returns the pool.  Attention k/v
    (prefill (B, S, KV, hd), pool (n_slots, T, KV, hd)) go to positions
    [0, S); the Mamba leaves (ssm state and conv history) have no
    sequence axis and are replaced whole.  One request is B = 1; a
    whole-batch prefill at slot 0 fills the pool
    (``serve.pad_caches_to``).  Stale k/v past S from an earlier occupant
    are never read: decode attends only to positions <= the slot's offset
    and writes each position before reaching it."""
    for buf, small in zip(pool, caches_small):
        for name, s in small.items():
            rows = buf[name][slot:slot + s.shape[0]]
            if name in ("k", "v"):
                rows = rows[:, :s.shape[1]]
            rows.copy_(s)
    return pool


def init_caches_for(cfg: ModelConfig, shape: ShapeConfig):
    """``(dtype=..., device=...) -> caches``: zeroed decode caches of
    ``shape.global_batch`` rows of ``shape.seq_len`` positions
    (``transformer.init_lm_cache``)."""
    _check_family(cfg)
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
