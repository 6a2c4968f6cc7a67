"""Decoder-only LM assembly, dense family only.

A ``TransformerLM`` holds the Bloom (or dense) token embedding, a
``ModuleList`` of pre-norm blocks (RMSNorm -> self-attention -> residual,
RMSNorm -> SwiGLU -> residual) and the final norm; the LM head is the
embedding transposed when tied.  ``lm_apply`` runs it:

  train   — a full sequence from position 0, no caches; all-position
            logits for the loss (``lm_loss_fn``), differentiated by
            autograd (no remat: the reference's ``remat`` policy has no
            counterpart here);
  prefill — the same, and also each layer's compact KV cache;
  decode  — one token per row against the per-layer cache pool at each
            row's own position (B,).

``TransformerLM.forward(batch)`` is the training objective
(``lm_loss_fn``), so ``torch.func.functional_call`` can evaluate it on
other parameters (the train step's compute-dtype copies).

The JAX package stacks its blocks under a leading ``(n_super, ...)`` axis
and scans them; here they are a Python loop over the ModuleList (PyTorch
runs eagerly, so there is nothing to compile).  MoE, Mamba, hybrid,
frontend and encoder-decoder families raise (ROADMAP A12).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, io, layers


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the "
            "port serves dense decoder-only LMs (MoE, Mamba, hybrid, "
            "frontend and encoder-decoder models: ROADMAP A12)")


class SwiGLU(nn.Module):
    """The dense FFN's weights (reference layout: (D, F), (D, F), (F, D))."""

    def __init__(self, d_model: int, d_ff: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_gate = nn.Parameter(
            layers.truncated_normal((d_model, d_ff), 1.0, generator))
        self.w_up = nn.Parameter(
            layers.truncated_normal((d_model, d_ff), 1.0, generator))
        self.w_down = nn.Parameter(
            layers.truncated_normal((d_ff, d_model), 1.0, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layers.swiglu(self.w_gate, self.w_up, self.w_down, x)


class Block(nn.Module):
    """One pre-norm decoder block; ``norm1`` / ``norm2`` are the f32 RMSNorm
    gains."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = attention.Attention(cfg, generator)
        self.norm2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, generator)


class TransformerLM(nn.Module):
    """The dense decoder LM, initialised on the CPU in f32 from
    ``generator`` (the reference's draws, not its numbers)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        p = io.io_init(cfg, generator)
        self.embed = nn.Parameter(p["embed"])
        self.head = nn.Parameter(p["head"]) if "head" in p else None
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    def forward(self, batch: Mapping[str, torch.Tensor]):
        """(loss, {"ce", "aux"}) of ``batch`` (see ``lm_loss_fn``)."""
        return lm_loss_fn(self, self.cfg, batch)


def init_lm_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype=torch.bfloat16, device=None
                  ) -> List[Dict[str, torch.Tensor]]:
    """Zeroed decode caches: one {"k", "v"} (batch, cache_len, KV, hd) per
    layer."""
    _check_dense(cfg)
    return [attention.init_kv_cache(cfg, batch, cache_len, dtype, device)
            for _ in range(cfg.num_layers)]


def lm_apply(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor,
             mode: str = "prefill", caches=None,
             pos: Optional[torch.Tensor] = None) -> dict:
    """Run the LM on tokens (B, S).

    train   -> {"logits" (B, S, m_vocab)};
    prefill -> {"logits" (B, S, m_vocab), "caches": per-layer {"k","v"}
               (B, S, KV, hd)};
    decode  -> {"logits" (B, 1, m_vocab), "caches"}: needs ``caches``
               (per-layer (B, T, KV, hd) pools, updated in place and
               returned) and ``pos`` (B,) int, each row's position.
    """
    x = io.embed_tokens(model.embed, cfg, tokens)
    B, S = tokens.shape
    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = [] if mode == "prefill" else None
    elif mode == "decode":
        if caches is None or pos is None:
            raise ValueError("decode needs caches and pos")
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                         f"got {mode!r}")
    for i, blk in enumerate(model.blocks):
        h = layers.rms_norm(blk.norm1, x, cfg.norm_eps)
        if mode == "train":
            y = attention.self_attention(blk.attn, cfg, h, positions)
        elif mode == "prefill":
            y, kv = attention.self_attention_with_cache(blk.attn, cfg, h,
                                                        positions)
            caches.append(kv)
        else:
            y = attention.decode_self_attention(blk.attn, cfg, h, caches[i],
                                                pos)
        x = x + y
        x = x + blk.ffn(layers.rms_norm(blk.norm2, x, cfg.norm_eps))
    x = layers.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = io.lm_logits(model.embed, model.head, cfg, x)
    if mode == "train":
        return {"logits": logits}
    return {"logits": logits, "caches": caches}


def lm_loss_fn(model: TransformerLM, cfg: ModelConfig,
               batch: Mapping[str, torch.Tensor]):
    """Next-token CE.  batch: {"tokens" (B, S)} and optionally
    {"loss_mask" (B, S - 1)}.  Returns (loss, {"ce", "aux"}): the mean
    over predicted tokens (or over the mask), and the MoE auxiliary loss,
    0 for the dense family."""
    tokens = batch["tokens"]
    logits = lm_apply(model, cfg, tokens, mode="train")["logits"]
    valid = batch.get("loss_mask")
    loss_tok = io.lm_loss(cfg, logits[:, :-1], tokens[:, 1:], valid)
    if valid is None:
        loss = loss_tok.sum() / max(loss_tok.numel(), 1)
    else:
        loss = loss_tok.sum() / torch.clamp(valid.sum().float(), min=1.0)
    aux = torch.zeros((), device=loss.device)
    return loss, {"ce": loss, "aux": aux}


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``lm_init`` tree (numpy arrays) as this module's
    state dict.  The reference stacks its blocks under
    ``tree["blocks"]["sub0"]`` with a leading (n_layers, ...) axis; the
    weight layouts are the same on both sides."""
    _check_dense(cfg)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"embed": t(tree["io"]["embed"]),
          "final_norm": t(tree["final_norm"]["scale"])}
    if "head" in tree["io"]:
        sd["head"] = t(tree["io"]["head"])
    sub = tree["blocks"]["sub0"]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        sd[pre + "norm1"] = t(sub["norm1"]["scale"][i])
        sd[pre + "norm2"] = t(sub["norm2"]["scale"][i])
        for name, a in sub["attn"].items():
            # the q/k norm gains are {"scale": (L, hd)} like the block norms
            sd[pre + "attn." + name] = t(a["scale"][i] if isinstance(a, dict)
                                         else a[i])
        for name, a in sub["ffn"].items():
            sd[pre + "ffn." + name] = t(a[i])
    return sd
