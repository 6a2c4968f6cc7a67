"""Decoder-only LM assembly: the dense, MoE, SSM and hybrid families.

A ``TransformerLM`` holds the Bloom (or dense) token embedding, a
``ModuleList`` of pre-norm blocks and the final norm; the LM head is the
embedding transposed when tied.  Each block takes its roles from the
reference's layer-role layout: layers are grouped into super-blocks of
``period_of(cfg)`` sub-layers (1 for homogeneous stacks, 8 for jamba's
1-attn : 7-mamba interleave), and layer i is sub-layer ``i % period`` of
super-block ``i // period``, with the mixer (``attn`` or ``mamba``) and
the FFN (``dense``, ``moe`` or ``none``) of ``sublayer_roles(cfg)[i %
period]``.  A block is RMSNorm -> mixer -> residual, then, unless its FFN
is ``none``, RMSNorm -> FFN -> residual.  ``lm_apply`` runs it:

  train   — a full sequence from position 0, no caches; all-position
            logits and the MoE auxiliary loss for the objective
            (``lm_loss_fn``), differentiated by autograd (no remat: the
            reference's ``remat`` policy has no counterpart here);
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
ModuleList (PyTorch runs eagerly, so there is nothing to compile).  The
vision-frontend and encoder-decoder families raise (ROADMAP A12 items
6-7).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, io, layers, mamba2, moe
from repro_torch.models.layers import SwiGLU


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the "
            "port serves decoder-only LMs: dense, moe, ssm and hybrid "
            "(the frontend and encoder-decoder models: ROADMAP A12 items "
            "6-7)")


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


def compute_cast(name: str, p: torch.Tensor) -> bool:
    """Whether the serving cast takes the param ``name``: the reference
    casts every floating param of ndim >= 2 of its layer-STACKED tree, in
    which each block param carries a leading layer axis.  So every block
    param (the per-layer RMSNorm gains, the (H, hd) QKV biases and the
    Mamba mixers' 1-D ``A_log``, ``D``, ``dt_bias``, conv biases and norm
    too) and the embedding go to the compute dtype, and only the final
    norm's 1-D gain stays f32."""
    return p.is_floating_point() and (p.ndim >= 2
                                      or name.startswith("blocks."))


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
        done("", self)
        roles = sublayer_roles(cfg)
        num_superblocks(cfg)
        self.blocks = nn.ModuleList()
        for i in range(cfg.num_layers):
            self.blocks.append(Block(cfg, roles[i % len(roles)], generator))
            done(f"blocks.{i}", self.blocks[i])
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    def forward(self, batch: Mapping[str, torch.Tensor]):
        """(loss, {"ce", "aux"}) of ``batch`` (see ``lm_loss_fn``)."""
        return lm_loss_fn(self, self.cfg, batch)


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


def lm_apply(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor,
             mode: str = "prefill", caches=None,
             pos: Optional[torch.Tensor] = None) -> dict:
    """Run the LM on tokens (B, S).

    train   -> {"logits" (B, S, m_vocab), "aux"};
    prefill -> {"logits" (B, S, m_vocab), "aux", "caches": per layer
               {"k","v"} (B, S, KV, hd) or the Mamba cache};
    decode  -> {"logits" (B, 1, m_vocab), "aux", "caches"}: needs
               ``caches`` (the per-layer pool of ``init_lm_cache``,
               updated in place and returned) and ``pos`` (B,) int, each
               row's position (read by the attention layers only).

    ``aux`` is the f32 sum of the MoE layers' load-balance losses (0
    without MoE).
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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(model.blocks):
        h = layers.rms_norm(blk.norm1, x, cfg.norm_eps)
        if blk.mixer == "attn":
            if mode == "train":
                y = attention.self_attention(blk.attn, cfg, h, positions)
            elif mode == "prefill":
                y, kv = attention.self_attention_with_cache(blk.attn, cfg,
                                                            h, positions)
                caches.append(kv)
            else:
                y = attention.decode_self_attention(blk.attn, cfg, h,
                                                    caches[i], pos)
        elif mode == "train":
            y = mamba2.mamba_apply(blk.mamba, cfg, h)
        elif mode == "prefill":
            y, mc = mamba2.mamba_apply(blk.mamba, cfg, h, return_cache=True)
            caches.append(mc)
        else:
            y, _ = mamba2.mamba_decode_step(blk.mamba, cfg, h, caches[i])
        x = x + y
        if blk.ffn_kind == "none":
            continue
        h = layers.rms_norm(blk.norm2, x, cfg.norm_eps)
        if blk.ffn_kind == "moe":
            y, a = moe.moe_apply(blk.ffn, h, cfg)
            aux = aux + a
        else:
            y = blk.ffn(h)
        x = x + y
    x = layers.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = io.lm_logits(model.embed, model.head, cfg, x)
    if mode == "train":
        return {"logits": logits, "aux": aux}
    return {"logits": logits, "aux": aux, "caches": caches}


def lm_loss_fn(model: TransformerLM, cfg: ModelConfig,
               batch: Mapping[str, torch.Tensor]):
    """Next-token CE plus the MoE auxiliary loss.  batch: {"tokens"
    (B, S)} and optionally {"loss_mask" (B, S - 1)}.  Returns (loss,
    {"ce", "aux"}): ce is the mean over predicted tokens (or over the
    mask), and loss = ce + aux_loss_weight * aux / num_superblocks, as
    in the reference (divided by the super-blocks, not the MoE layers)."""
    tokens = batch["tokens"]
    out = lm_apply(model, cfg, tokens, mode="train")
    logits = out["logits"]
    valid = batch.get("loss_mask")
    loss_tok = io.lm_loss(cfg, logits[:, :-1], tokens[:, 1:], valid)
    if valid is None:
        loss = loss_tok.sum() / max(loss_tok.numel(), 1)
    else:
        loss = loss_tok.sum() / torch.clamp(valid.sum().float(), min=1.0)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = loss + aux_w * out["aux"] / max(num_superblocks(cfg), 1)
    return total, {"ce": loss, "aux": out["aux"]}


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``lm_init`` tree (numpy arrays) as this module's
    state dict.  The reference stacks sub-layer j of every super-block
    under ``tree["blocks"][f"sub{j}"]`` with a leading (n_super, ...)
    axis; layer i is entry ``i // period`` of ``sub{i % period}``.  The
    weight layouts are the same on both sides; a norm's {"scale"} dict is
    the port's one gain param, and the nested dicts (the shared experts,
    the Mamba convs) become sub-module names."""
    _check_family(cfg)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"embed": t(tree["io"]["embed"]),
          "final_norm": t(tree["final_norm"]["scale"])}
    if "head" in tree["io"]:
        sd["head"] = t(tree["io"]["head"])

    def put(prefix: str, node, s: int) -> None:
        if isinstance(node, Mapping):
            if set(node) == {"scale"}:
                sd[prefix] = t(node["scale"][s])
                return
            for name, child in node.items():
                put(f"{prefix}.{name}", child, s)
        else:
            sd[prefix] = t(node[s])

    p = period_of(cfg)
    for i in range(cfg.num_layers):
        put(f"blocks.{i}", tree["blocks"][f"sub{i % p}"], i // p)
    return sd
