"""Decoder-only LM assembly: the dense, MoE, SSM, hybrid and vlm families.

A ``TransformerLM`` holds the Bloom (or dense) token embedding, a
``ModuleList`` of pre-norm blocks and the final norm; the LM head is the
embedding transposed when tied.  A config with a stub ``frontend`` (the
``vlm`` family) adds ``frontend_proj``, a bias-free D x D dense layer
that projects precomputed image embeddings (B, S_emb, D) into S_emb
positions ahead of the tokens (``lm_apply``'s ``embeds``).  Each block
takes its roles from the reference's layer-role layout: layers are
grouped into super-blocks of ``period_of(cfg)`` sub-layers (1 for
homogeneous stacks, 8 for jamba's 1-attn : 7-mamba interleave), and
layer i is sub-layer ``i % period`` of super-block ``i // period``, with
the mixer (``attn`` or ``mamba``) and the FFN (``dense``, ``moe`` or
``none``) of ``sublayer_roles(cfg)[i % period]``.  A block is RMSNorm -> mixer -> residual, then, unless its FFN
is ``none``, RMSNorm -> FFN -> residual.  ``lm_apply`` runs it:

  train   — a full sequence from position 0, no caches; all-position
            logits and the MoE auxiliary loss for the objective
            (``lm_loss_fn``), differentiated by autograd, each super-block
            under ``cfg.remat``'s checkpoint policy (``remat_apply``);
  prefill — the same, and also each layer's decode cache: compact KV for
            an attention layer, conv history and SSM state for a Mamba
            layer;
  decode  — one token per row against the per-layer cache pool, each
            attention layer at each row's own position (B,); Mamba
            layers carry no position.

``TransformerLM.forward(batch)`` is the training objective
(``lm_loss_fn``), so ``torch.func.functional_call`` can evaluate it on
other parameters (the train step's compute-dtype copies).

The JAX package stacks its super-blocks under a leading ``(n_super,
...)`` axis and scans them; here they are a Python loop over the
ModuleList, one super-block of ``period_of(cfg)`` layers at a time
(PyTorch runs eagerly, so there is nothing to compile).  In training,
with gradients wanted, each super-block runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference's
``jax.checkpoint`` wraps each: ``remat="full"`` keeps only the block's
inputs and recomputes the rest in the backward; ``"dots"`` also keeps
the outputs of the matmuls with no batch dims (a selective-checkpoint
policy, the counterpart of ``dots_with_no_batch_dims_saveable``);
``"none"`` keeps every activation.  The Bloom embedding, the head and
the CE stay outside every checkpoint, so a step launches each Bloom
kernel once; the collectives inside a block (the Megatron pair, the
MoE's count all-gather under a data axis, the Mamba norm's all-reduce)
run again in the recompute, in the same order on every rank, and the
MoE's auxiliary loss is an output of the block.  The
encoder-decoder family (``audio``) is ``models/encdec.py``.
``reference_path`` maps each param name to its leaf in the reference's
tree (``lm_params_from_jax`` loads by it, and launch/sharding.py reads
the reference's placement rules by it).

Under a mesh (``dist``, launch/sharding.DistContext) with a ``model``
axis of more than one, the module holds each rank's local shard of every
param (``sharding.shard_module``) and ``lm_apply`` runs every family
tensor-parallel: the vocab-parallel Bloom embedding and head
(models/io.py), the attention's heads, the SwiGLU's d_ff columns and the
Mamba-2 mixer's heads split over ``model`` with the row-parallel outputs
all-reduced, and the MoE's experts split (``moe_impl="ep"``), each where
the reference's rules split it (a layer whose dim does not divide the
axis runs whole on every rank).  The ``vlm`` frontend's ``frontend_proj``
is replicated and its embeddings join the token embeddings before the
first block.  The train, prefill and decode modes run so; decode reads
this rank's cache shards, an attention cache whose sequence splits slice
by slice (``dist.seq_shard``, models/attention.py).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.models import attention, io, layers, mamba2, moe
from repro_torch.models.layers import SwiGLU


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the encoder-decoder family (audio) is "
            "models.encdec.EncDec, not a decoder-only TransformerLM")


# --------------------------------------------------------------------------
# Layer-role layout
# --------------------------------------------------------------------------

def period_of(cfg: ModelConfig) -> int:
    p = cfg.attn_layer_period if cfg.attn_layer_period > 0 else 1
    q = cfg.moe_layer_period if cfg.moe is not None else 1
    return math.lcm(p, q)


def sublayer_roles(cfg: ModelConfig):
    """[(mixer, ffn)] for one period; mixer: attn|mamba, ffn:
    dense|moe|none."""
    roles = []
    for j in range(period_of(cfg)):
        mixer = "attn" if cfg._layer_is_attention(j) else "mamba"
        if cfg._layer_is_moe(j):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        roles.append((mixer, ffn))
    return roles


def num_superblocks(cfg: ModelConfig) -> int:
    p = period_of(cfg)
    if cfg.num_layers % p:
        raise ValueError(f"num_layers {cfg.num_layers} must divide into "
                         f"period {p}")
    return cfg.num_layers // p


_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the matmuls with no batch
    dims (``mm``, ``addmm``, and a ``bmm`` over a batch of one, which is
    how ``torch.einsum`` runs a product that contracts no batch axis, the
    projections'), recompute everything else (the attention's and the
    experts' batched products among it)."""
    if op in _NO_BATCH_DOTS or (op is torch.ops.aten.bmm.default
                                and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _rebound(bound):
    """Bind each (module, name, tensor) of ``bound`` as the module's param
    ``name`` for the block, as ``torch.func.functional_call`` binds them
    (in the module's ``_parameters``), and restore what was there."""
    held = [(m, n, m._parameters[n]) for m, n, _ in bound]
    for m, n, t in bound:
        m._parameters[n] = t
    try:
        yield
    finally:
        for m, n, t in held:
            m._parameters[n] = t


def remat_apply(cfg: ModelConfig, modules, fn, *args):
    """``fn(*args)``, a block that reads the params of ``modules``, under
    ``cfg.remat``'s checkpoint policy when gradients are wanted (the
    module's docstring); plainly under ``remat="none"`` or without
    gradients.  The recompute reads the params the forward read: the
    train step binds compute-dtype copies of them in a functional call
    of its own (``steps.value_and_grad``), which has ended by the time
    the backward recomputes, so they are rebound around each run.  No
    module is called (a module's hooks, e.g. ``FlopCounterMode``'s, would
    hold on to the recompute's graph).  The blocks draw no random
    numbers, so no RNG state is kept."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    bound = [(m, n, t) for mod in modules for m in mod.modules()
             for n, t in m._parameters.items()]

    def run(*a):
        with _rebound(bound):
            return fn(*a)

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(run, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def compute_cast(name: str, p: torch.Tensor) -> bool:
    """Whether the serving cast takes the param ``name``: the reference
    casts every floating param of ndim >= 2 of its layer-STACKED tree, in
    which each block param carries a leading layer axis.  So every block
    param (the per-layer RMSNorm gains, the (H, hd) QKV biases and the
    Mamba mixers' 1-D ``A_log``, ``D``, ``dt_bias``, conv biases and norm
    too; an ``encdec.EncDec``'s ``encoder.*`` and ``decoder.*`` blocks
    alike), the embedding and ``frontend_proj`` go to the compute dtype,
    and only the 1-D final norm (and the encoder's ``enc_norm``) stays
    f32."""
    return p.is_floating_point() and (
        p.ndim >= 2 or name.startswith(("blocks.", "encoder.", "decoder.")))


def cast_for_compute(module: nn.Module, prefix: str, dtype) -> None:
    """Cast in place to ``dtype`` the params of ``module`` (named under
    ``prefix``, as in the whole model) that the serving cast takes
    (``compute_cast``)."""
    with torch.no_grad():
        for name, p in module.named_parameters(prefix=prefix):
            if compute_cast(name, p):
                p.data = p.data.to(dtype)


class Block(nn.Module):
    """One pre-norm decoder block of roles ``(mixer, ffn)``: ``norm1`` and
    ``attn`` or ``mamba``, then ``norm2`` and ``ffn`` (a SwiGLU or an
    ``moe.MoE``) unless the FFN is ``none``.  The norms are the f32
    RMSNorm gains."""

    def __init__(self, cfg: ModelConfig, roles=("attn", "dense"),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mixer, self.ffn_kind = roles
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model))
        if self.mixer == "attn":
            self.attn = attention.Attention(cfg, generator)
        else:
            self.mamba = mamba2.Mamba2(cfg, generator)
        if self.ffn_kind != "none":
            self.norm2 = nn.Parameter(torch.ones(cfg.d_model))
            self.ffn = (moe.MoE(cfg, generator) if self.ffn_kind == "moe"
                        else SwiGLU(cfg.d_model, cfg.d_ff, generator))


class TransformerLM(nn.Module):
    """The decoder LM, initialised in f32 from ``generator`` (the
    reference's draws, not its numbers) on the default device.  With
    ``cast=True`` the serving cast (``compute_cast``) is applied as the
    weights are drawn — the embedding and head, then each block before
    the next is drawn — so the peak is the cast model plus one f32
    block, and the draws are the same as without it."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 cast: bool = False):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)

        def done(prefix: str, module: nn.Module) -> None:
            if cast:
                cast_for_compute(module, prefix, dt)

        p = io.io_init(cfg, generator)
        self.embed = nn.Parameter(p["embed"])
        self.head = nn.Parameter(p["head"]) if "head" in p else None
        if cfg.frontend != "none":
            self.frontend_proj = nn.Parameter(layers.truncated_normal(
                (cfg.d_model, cfg.d_model), 1.0, generator))
        done("", self)
        roles = sublayer_roles(cfg)
        num_superblocks(cfg)
        self.blocks = nn.ModuleList()
        for i in range(cfg.num_layers):
            self.blocks.append(Block(cfg, roles[i % len(roles)], generator))
            done(f"blocks.{i}", self.blocks[i])
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    def forward(self, batch: Mapping[str, torch.Tensor], dist=None):
        """(loss, {"ce", "aux"}) of ``batch`` (see ``lm_loss_fn``)."""
        return lm_loss_fn(self, self.cfg, batch, dist)


def init_lm_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype=torch.bfloat16, device=None
                  ) -> List[Dict[str, torch.Tensor]]:
    """Zeroed decode caches, one dict per layer by its mixer: {"k", "v"}
    (batch, cache_len, KV, hd) for attention, {"ssm", "conv_x", "conv_b",
    "conv_c"} (no sequence axis) for Mamba."""
    _check_family(cfg)
    roles = sublayer_roles(cfg)
    return [attention.init_kv_cache(cfg, batch, cache_len, dtype, device)
            if roles[i % len(roles)][0] == "attn"
            else mamba2.init_mamba_cache(cfg, batch, dtype, device)
            for i in range(cfg.num_layers)]


def frontend_concat(model: TransformerLM, x_tokens: torch.Tensor,
                    embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The stub frontend: ``embeds`` (B, S_emb, D) projected by
    ``frontend_proj`` in the tokens' dtype, ahead of the token embeddings
    x_tokens (B, S, D) -> (B, S_emb + S, D); x_tokens alone without
    ``embeds``."""
    if embeds is None:
        return x_tokens
    dt = x_tokens.dtype
    pre = embeds.to(dt) @ model.frontend_proj.to(dt)
    return torch.cat([pre, x_tokens], dim=1)


def _layer_apply(blk: Block, cfg: ModelConfig, i: int, x: torch.Tensor,
                 positions, mode: str, caches, pos, dist):
    """Layer i, the block ``blk``, in ``mode``: (x, the MoE loss or
    None); prefill appends the layer's cache to ``caches``, decode
    updates ``caches[i]``."""
    h = layers.rms_norm(blk.norm1, x, cfg.norm_eps)
    if blk.mixer == "attn":
        if mode == "train":
            y = attention.self_attention(blk.attn, cfg, h, positions,
                                         dist=dist)
        elif mode == "prefill":
            y, kv = attention.self_attention_with_cache(
                blk.attn, cfg, h, positions, dist=dist)
            caches.append(kv)
        else:
            y = attention.decode_self_attention(
                blk.attn, cfg, h, caches[i], pos, dist,
                None if dist is None else dist.seq_shard(i, "k"))
    elif mode == "train":
        y = mamba2.mamba_apply(blk.mamba, cfg, h, dist=dist)
    elif mode == "prefill":
        y, mc = mamba2.mamba_apply(blk.mamba, cfg, h, return_cache=True,
                                   dist=dist)
        caches.append(mc)
    else:
        y, _ = mamba2.mamba_decode_step(blk.mamba, cfg, h, caches[i], dist)
    x = x + y
    if blk.ffn_kind == "none":
        return x, None
    h = layers.rms_norm(blk.norm2, x, cfg.norm_eps)
    aux = None
    if blk.ffn_kind == "moe":
        y, aux = moe.moe_apply(blk.ffn, h, cfg, dist)
    else:
        y = layers.swiglu_module(blk.ffn, h, cfg.d_ff, dist)
    return x + y, aux


def _superblock_apply(blocks, first: int, cfg: ModelConfig,
                      x: torch.Tensor, positions, mode: str, caches, pos,
                      dist):
    """One super-block, layers ``first`` ... of ``blocks``: (x, the f32
    sum of its MoE losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, blk in enumerate(blocks):
        x, a = _layer_apply(blk, cfg, first + j, x, positions, mode, caches,
                            pos, dist)
        if a is not None:
            aux = aux + a
    return x, aux


def lm_apply(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor,
             mode: str = "prefill", caches=None,
             pos: Optional[torch.Tensor] = None,
             embeds: Optional[torch.Tensor] = None, dist=None) -> dict:
    """Run the LM on tokens (B, S), after the stub frontend's S_emb
    positions when ``embeds`` (B, S_emb, D) are given (train and prefill;
    positions then run over S_tot = S_emb + S).

    train   -> {"logits" (B, S_tot, m_vocab), "aux"};
    prefill -> {"logits" (B, S_tot, m_vocab), "aux", "caches": per layer
               {"k","v"} (B, S_tot, KV, hd) or the Mamba cache};
    decode  -> {"logits" (B, 1, m_vocab), "aux", "caches"}: needs
               ``caches`` (the per-layer pool of ``init_lm_cache``,
               updated in place and returned) and ``pos`` (B,) int, each
               row's position (read by the attention layers only).

    ``aux`` is the f32 sum of the MoE layers' load-balance losses (0
    without MoE).  ``dist`` runs the model tensor-parallel over its
    ``model`` axis: the logits are then this rank's columns of the m-dim
    logits when the vocab is sharded, and the caches (returned by
    prefill, taken and returned by decode) its shards.
    """
    x = io.embed_tokens(model.embed, cfg, tokens, dist)
    if mode != "decode":
        x = frontend_concat(model, x, embeds)
    B, S = x.shape[:2]
    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = [] if mode == "prefill" else None
    elif mode == "decode":
        if caches is None or pos is None:
            raise ValueError("decode needs caches and pos")
        positions = None
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                         f"got {mode!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    period = period_of(cfg)
    for first in range(0, len(model.blocks), period):
        span = list(model.blocks[first:first + period])
        args = (span, first, cfg, x, positions, mode, caches, pos, dist)
        x, a = (remat_apply(cfg, span, _superblock_apply, *args)
                if mode == "train" else _superblock_apply(*args))
        aux = aux + a
    x = layers.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = io.lm_logits(model.embed, model.head, cfg, x, dist)
    if mode == "train":
        return {"logits": logits, "aux": aux}
    return {"logits": logits, "aux": aux, "caches": caches}


def lm_loss_fn(model: TransformerLM, cfg: ModelConfig,
               batch: Mapping[str, torch.Tensor], dist=None):
    """Next-token CE plus the MoE auxiliary loss.  batch: {"tokens"
    (B, S)} and optionally {"embeds" (B, S_emb, D)} (the stub frontend's
    prefix) and {"loss_mask" (B, S - 1)}.  Returns (loss, {"ce", "aux"}):
    ce is the mean over predicted tokens of the text region (or over the
    mask), and loss = ce + aux_loss_weight * aux / num_superblocks, as
    in the reference (divided by the super-blocks, not the MoE layers).

    Under ``dist`` with batch axes of more than one, ``batch`` is this
    rank's rows of the global batch (split evenly): ce is its summed loss
    over the GLOBAL count of predicted tokens, times the number of batch
    shards, so that the shards' mean (the step's gradient mean) is the
    global batch's ce."""
    tokens = batch["tokens"]
    out = lm_apply(model, cfg, tokens, mode="train",
                   embeds=batch.get("embeds"), dist=dist)
    logits = out["logits"][:, out["logits"].shape[1] - tokens.shape[1]:]
    valid = batch.get("loss_mask")
    loss_tok = io.lm_loss(cfg, logits[:, :-1], tokens[:, 1:], valid, dist)
    if dist is not None and dist.n_batch > 1:
        n = (torch.tensor(float(loss_tok.numel()), device=loss_tok.device)
             if valid is None else valid.sum().float())
        n = collectives.all_reduce_sum(n, dist, "batch")
        loss = loss_tok.sum() * dist.n_batch / torch.clamp(n, min=1.0)
    elif valid is None:
        loss = loss_tok.sum() / max(loss_tok.numel(), 1)
    else:
        loss = loss_tok.sum() / torch.clamp(valid.sum().float(), min=1.0)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = loss + aux_w * out["aux"] / max(num_superblocks(cfg), 1)
    return total, {"ce": loss, "aux": out["aux"]}


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def reference_path(name: str, cfg: ModelConfig
                   ) -> Tuple[str, Optional[int]]:
    """The reference tree's leaf of the port param ``name`` (of a
    ``TransformerLM`` or an ``encdec.EncDec``): its "/"-joined path, as
    the reference's sharding rules read it, and its entry on the leading
    stacked axis (None for an unstacked leaf).  The reference stacks
    sub-layer j of every super-block under ``blocks/sub{j}`` (layer i is
    entry ``i // period`` of ``sub{i % period}``) and the encoder's and
    decoder's blocks under ``encoder`` / ``decoder`` (block i is entry i);
    the embedding and head sit under ``io``; ``frontend_proj`` is a dense
    layer {"w"}; a norm's {"scale"} dict is the port's one gain param;
    every other nested dict (the shared experts, the Mamba convs) is a
    sub-module of the same name."""
    parts = name.split(".")
    if parts[0] in ("embed", "head"):
        return f"io/{parts[0]}", None
    if parts[0] == "frontend_proj":
        return "frontend_proj/w", None
    stacked = None
    if parts[0] == "blocks":
        i, p = int(parts[1]), period_of(cfg)
        parts, stacked = ["blocks", f"sub{i % p}", *parts[2:]], i // p
    elif parts[0] in ("encoder", "decoder"):
        parts, stacked = [parts[0], *parts[2:]], int(parts[1])
    if "norm" in parts[-1]:
        parts.append("scale")
    return "/".join(parts), stacked


def param_names(model_cls, cfg: ModelConfig) -> List[str]:
    """The param names of ``model_cls(cfg)``, built on the ``meta``
    device (no storage, no draws)."""
    with torch.device("meta"):
        return [n for n, _ in model_cls(cfg).named_parameters()]


def params_from_jax(tree: Mapping, cfg: ModelConfig, model_cls
                    ) -> Dict[str, torch.Tensor]:
    """The reference's param tree (numpy arrays) as the state dict of
    ``model_cls(cfg)``: each param read at its ``reference_path`` (the
    weight layouts are the same on both sides)."""
    sd = {}
    for name in param_names(model_cls, cfg):
        path, stacked = reference_path(name, cfg)
        leaf = tree
        for key in path.split("/"):
            leaf = leaf[key]
        sd[name] = _f32(leaf if stacked is None else leaf[stacked])
    return sd


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``lm_init`` tree (numpy arrays) as this module's
    state dict (``params_from_jax`` by ``reference_path``)."""
    _check_family(cfg)
    return params_from_jax(tree, cfg, TransformerLM)
