"""Encoder-decoder (whisper-style) transformer: the ``audio`` family.

The audio conv frontend is a stub, as in the reference: the caller
supplies precomputed frame embeddings (B, S_enc, D), and a bias-free
D x D dense layer (``frontend_proj``) stands in for the conv stack.  The
encoder is pre-norm blocks of non-causal RoPE self-attention and SwiGLU,
then ``enc_norm``.  The decoder's blocks are causal self-attention, cross
attention over the encoder output (no RoPE, not causal) and SwiGLU, each
behind its RMSNorm; its vocabulary IO is the Bloom layer of the
decoder-only LMs (``models/io.py``: the embed kernel's token entry in,
the fused CE in training, Eq. 3 top-k out).

``encdec_apply`` runs it:

  train   — the encoder over the frames, the decoder over the tokens from
            position 0; all-position logits for ``encdec_loss_fn``;
  prefill — the same, and each decoder layer's cache: the compact
            self-attention KV (B, S, KV, hd) and the cross attention's k/v
            of the encoder output (B, S_enc, KV, hd);
  decode  — one token per row; the encoder does not run: the cross
            attention reads the cached k/v, and the self-attention writes
            each row's new k/v at its own position (B,) in place.

Params keep the reference's tree (``encdec.py:24-58``): the embedding and
head, ``frontend_proj`` (D, D) in its (in, out) layout, the encoder blocks
(``norm1``, ``attn``, ``norm2``, ``ffn``), ``enc_norm``, the decoder
blocks (``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
``ffn``) and ``final_norm``; the reference stacks its blocks under a
leading layer axis and scans them, here they are ModuleLists
(``encdec_params_from_jax`` unstacks them).  With gradients wanted, each
encoder block and each decoder block in training runs under
``cfg.remat``'s checkpoint policy (``transformer.remat_apply``), as the
reference's ``jax.checkpoint`` wraps each (``encdec.py:84``, ``:169``);
a prefill runs without.  The attention is chunked over the frames
(models/attention.py).

Under a mesh (``dist``, launch/sharding.DistContext) the module holds
each rank's shards, and every mode runs as ``transformer.lm_apply``
does: the vocab-parallel Bloom embedding, head and CE; the encoder's
and the decoder's attention (self and cross) over the rank's heads and
their SwiGLU over its d_ff columns where they divide the ``model`` axis,
whole on every rank where they do not (whisper's 12 heads on 8 or 16);
``frontend_proj`` replicated.  At decode the self-attention and cross
caches are the rank's ``cache_pspecs`` shards, read slice by slice where
their sequence splits (``dist.seq_shard``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, io, layers
from repro_torch.models import transformer as tf
from repro_torch.models.layers import SwiGLU

# the reference's cache_specs frame count: whisper's 30 s window
ENC_LEN = 1500


class EncBlock(nn.Module):
    """One pre-norm encoder block: ``norm1``, ``attn``, ``norm2``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = attention.Attention(cfg, generator)
        self.norm2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, generator)


class DecBlock(nn.Module):
    """One pre-norm decoder block: ``norm1``, ``self_attn``, ``norm_x``,
    ``cross_attn``, ``norm2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model))
        self.self_attn = attention.Attention(cfg, generator)
        self.norm_x = nn.Parameter(torch.ones(cfg.d_model))
        self.cross_attn = attention.Attention(cfg, generator)
        self.norm2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, generator)


class EncDec(nn.Module):
    """The encoder-decoder, initialised in f32 from ``generator`` (the
    reference's draws, not its numbers) on the default device.  With
    ``cast=True`` the serving cast (``transformer.compute_cast``) is
    applied as the weights are drawn — the embedding, head and
    ``frontend_proj``, then each block before the next is drawn — so the
    peak is the cast model plus one f32 block, and the draws are the same
    as without it."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 cast: bool = False):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: EncDec is the audio family's "
                             f"model, not {cfg.family!r}'s")
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)

        def done(prefix: str, module: nn.Module) -> None:
            if cast:
                tf.cast_for_compute(module, prefix, dt)

        p = io.io_init(cfg, generator)
        self.embed = nn.Parameter(p["embed"])
        self.head = nn.Parameter(p["head"]) if "head" in p else None
        self.frontend_proj = nn.Parameter(layers.truncated_normal(
            (cfg.d_model, cfg.d_model), 1.0, generator))
        done("", self)
        self.encoder = nn.ModuleList()
        for i in range(cfg.encoder_layers):
            self.encoder.append(EncBlock(cfg, generator))
            done(f"encoder.{i}", self.encoder[i])
        self.enc_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.decoder = nn.ModuleList()
        for i in range(cfg.num_layers):
            self.decoder.append(DecBlock(cfg, generator))
            done(f"decoder.{i}", self.decoder[i])
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    def forward(self, batch: Mapping[str, torch.Tensor], dist=None):
        """(loss, {"ce", "aux"}) of ``batch`` (see ``encdec_loss_fn``).
        ``dist`` may split the batch (its mean is the shards' mean, equal
        shards) and the model (the module's docstring)."""
        return encdec_loss_fn(self, self.cfg, batch, dist)


def encode(model: EncDec, cfg: ModelConfig, frames: torch.Tensor,
           dist=None) -> torch.Tensor:
    """frames (B, S_enc, D) stub embeddings -> the encoder output
    (B, S_enc, D) in ``cfg.dtype``: ``frontend_proj``, then each block's
    non-causal RoPE self-attention and SwiGLU, then ``enc_norm``
    (tensor-parallel under ``dist``)."""
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt) @ model.frontend_proj.to(dt)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for blk in model.encoder:
        x = tf.remat_apply(cfg, [blk], _enc_block, blk, cfg, x, positions,
                           dist)
    return layers.rms_norm(model.enc_norm, x, cfg.norm_eps)


def _enc_block(blk: EncBlock, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, dist) -> torch.Tensor:
    h = layers.rms_norm(blk.norm1, x, cfg.norm_eps)
    x = x + attention.self_attention(blk.attn, cfg, h, positions,
                                     causal=False, dist=dist)
    h = layers.rms_norm(blk.norm2, x, cfg.norm_eps)
    return x + layers.swiglu_module(blk.ffn, h, cfg.d_ff, dist)


def _dec_block(blk: DecBlock, cfg: ModelConfig, i: int, x: torch.Tensor,
               positions, enc_out, mode: str, caches, pos,
               dist) -> torch.Tensor:
    """Decoder layer i, the block ``blk``, in ``mode``: prefill appends
    its caches to ``caches``, decode updates ``caches[i]``."""
    h = layers.rms_norm(blk.norm1, x, cfg.norm_eps)
    seq = seq_x = None
    if mode == "decode" and dist is not None:
        seq, seq_x = dist.seq_shard(i, "k"), dist.seq_shard(i, "cross_k")
    if mode == "train":
        y = attention.self_attention(blk.self_attn, cfg, h, positions,
                                     dist=dist)
    elif mode == "prefill":
        y, kv = attention.self_attention_with_cache(blk.self_attn, cfg,
                                                    h, positions, dist)
    else:
        y = attention.decode_self_attention(blk.self_attn, cfg, h,
                                            caches[i], pos, dist, seq)
    x = x + y
    h = layers.rms_norm(blk.norm_x, x, cfg.norm_eps)
    if mode == "decode":
        ck, cv = caches[i]["cross_k"], caches[i]["cross_v"]
    else:
        ck, cv = attention.cross_kv(blk.cross_attn, cfg, enc_out, dist)
    x = x + attention.cross_attention_kv(blk.cross_attn, cfg, h, ck, cv,
                                         dist, seq_x,
                                         decode=mode == "decode")
    if mode == "prefill":
        caches.append({**kv, "cross_k": ck, "cross_v": cv})
    h = layers.rms_norm(blk.norm2, x, cfg.norm_eps)
    return x + layers.swiglu_module(blk.ffn, h, cfg.d_ff, dist)


def encdec_apply(model: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                 mode: str = "prefill", caches=None,
                 pos: Optional[torch.Tensor] = None,
                 embeds: Optional[torch.Tensor] = None, dist=None) -> dict:
    """Run the encoder-decoder on the decoder tokens (B, S) and, in train
    and prefill, the frames ``embeds`` (B, S_enc, D).

    train   -> {"logits" (B, S, m_vocab), "aux"};
    prefill -> {"logits", "aux", "caches": per decoder layer {"k","v"}
               (B, S, KV, hd) and {"cross_k","cross_v"} (B, S_enc, KV,
               hd)};
    decode  -> {"logits" (B, 1, m_vocab), "aux", "caches"}: needs
               ``caches`` (the pool of ``init_encdec_cache``, whose
               self-attention k/v are updated in place; returned) and
               ``pos`` (B,) int, each row's position.

    ``aux`` is 0 (no MoE), as in the reference.  ``dist``: the module's
    docstring (the logits are then this rank's columns where the vocab
    is sharded).
    """
    x = io.embed_tokens(model.embed, cfg, tokens, dist)
    B, S = tokens.shape
    if mode in ("train", "prefill"):
        if embeds is None:
            raise ValueError(f"{mode} needs the encoder's frames (embeds)")
        positions = torch.arange(S, device=x.device).expand(B, S)
        enc_out = encode(model, cfg, embeds, dist)
        caches = [] if mode == "prefill" else None
    elif mode == "decode":
        if caches is None or pos is None:
            raise ValueError("decode needs caches and pos")
        positions = enc_out = None
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                         f"got {mode!r}")
    for i, blk in enumerate(model.decoder):
        args = (blk, cfg, i, x, positions, enc_out, mode, caches, pos, dist)
        x = (tf.remat_apply(cfg, [blk], _dec_block, *args)
             if mode == "train" else _dec_block(*args))
    x = layers.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = io.lm_logits(model.embed, model.head, cfg, x, dist)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return {"logits": logits, "aux": aux}
    return {"logits": logits, "aux": aux, "caches": caches}


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      enc_len: int, dtype=torch.bfloat16, device=None
                      ) -> List[Dict[str, torch.Tensor]]:
    """Zeroed decode caches, one dict per decoder layer: the
    self-attention's {"k", "v"} (batch, cache_len, KV, hd) and the cross
    attention's {"cross_k", "cross_v"} (batch, enc_len, KV, hd)."""
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{**attention.init_kv_cache(cfg, batch, cache_len, dtype, device),
             "cross_k": torch.zeros(shape, dtype=dtype, device=device),
             "cross_v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def encdec_loss_fn(model: EncDec, cfg: ModelConfig,
                   batch: Mapping[str, torch.Tensor], dist=None):
    """Next-token CE of the decoder.  batch: {"tokens" (B, S), "embeds"
    (B, S_enc, D)} and optionally {"loss_mask" (B, S - 1)}.  Returns
    (loss, {"ce", "aux"}): the mean of the per-token losses over every
    predicted position, masked ones counted as 0 — the reference's
    ``loss_tok.mean()``, not ``lm_loss_fn``'s mean over the mask.  Under
    ``dist`` the batch is this rank's rows (equal shards, so the shards'
    mean is the global mean)."""
    tokens = batch["tokens"]
    out = encdec_apply(model, cfg, tokens, mode="train",
                       embeds=batch["embeds"], dist=dist)
    loss_tok = io.lm_loss(cfg, out["logits"][:, :-1], tokens[:, 1:],
                          batch.get("loss_mask"), dist)
    loss = loss_tok.mean()
    return loss, {"ce": loss, "aux": out["aux"]}


def encdec_params_from_jax(tree: Mapping, cfg: ModelConfig
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``encdec_init`` tree (numpy arrays) as this
    module's state dict.  The reference stacks its ``encoder`` and
    ``decoder`` blocks under a leading layer axis: block i is entry i
    (``transformer.reference_path``, by which ``params_from_jax``
    reads each param)."""
    return tf.params_from_jax(tree, cfg, EncDec)
