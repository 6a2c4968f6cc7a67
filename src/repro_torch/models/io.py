"""Token IO boundary: embedding and LM head, dense or Bloom-compressed, and
the serving-time vocabulary recovery of Eq. 3.

With ``cfg.bloom.enabled`` the embedding table and the LM head live in the
m-dim hashed space: a token's input is the sum of its k hashed table rows
(``kernels.ops.bloom_embed``: the hand-written CUDA kernel for CUDA
tensors, its plain version for CPU tensors), and recovery scores every
vocab id by Eq. 3 and keeps the top k (``kernels.ops.bloom_decode_topk``,
the same split).  The training loss ``lm_loss`` takes the fused Bloom CE
(``kernels.ops.bloom_ce``, the same split again); both Bloom ops are
differentiable through their backward kernels.  There is no ``io_impl``
knob: the path follows the tensors' device, and every path reads the
quantized tables through the kernels' own storage model (``table_dtype``,
core/quant.py), so the reference's XLA-path ``_fake_quant_rows`` has no
counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import losses, quant
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import ops
from repro_torch.models import layers


def resolved_table_dtype(cfg: ModelConfig) -> Optional[str]:
    """ModelConfig.table_dtype -> the kernel-layer knob: the config
    default "auto" maps to ``None`` (legacy: the table cast to the
    activation dtype, no quantization); anything else is canonicalized by
    core.quant."""
    td = quant.resolve_table_dtype(cfg.table_dtype, allow_auto=True)
    return None if td == "auto" else td


def vocab_spec(cfg: ModelConfig) -> Optional[BloomSpec]:
    if not cfg.bloom.enabled:
        return None
    return BloomSpec(d=cfg.vocab, m=cfg.m_vocab, k=cfg.bloom.k,
                     seed=cfg.bloom.seed, on_the_fly=cfg.bloom.on_the_fly)


def io_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None
            ) -> dict:
    """{"embed": (m_vocab, D)} plus {"head": (D, m_vocab)} when the head is
    not tied: f32 CPU tensors, drawn as the reference draws them."""
    V, D = cfg.m_vocab, cfg.d_model
    p = {"embed": layers.embed_init((V, D), generator)}
    if not cfg.tie_embeddings:
        p["head"] = layers.truncated_normal((D, V), 1.0, generator)
    return p


def embed_tokens(embed: torch.Tensor, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, D) activations in ``cfg.dtype``.

    Bloom path: x = sum_j Table[H_j(tok)] — the dense-matrix product with
    the k-hot Bloom code of the paper, computed as a k-way gather-sum.
    With a quantized ``cfg.table_dtype`` the master-precision table goes
    in and the kernel reads it stored narrow (gradients straight-through
    to the master).  ``cfg.bwd_impl`` picks the table's backward: the CSR
    scatter-add or the dense m-tile sweep.
    """
    dt = getattr(torch, cfg.dtype)
    spec = vocab_spec(cfg)
    if spec is None:
        return embed[tokens.long()].to(dt)
    td = resolved_table_dtype(cfg)
    if td is None:
        return ops.bloom_embed(embed.to(dt), tokens, spec,
                               bwd_impl=cfg.bwd_impl)
    return ops.bloom_embed(embed, tokens, spec, bwd_impl=cfg.bwd_impl,
                           table_dtype=td, out_dtype=dt)


def lm_logits(embed: torch.Tensor, head: Optional[torch.Tensor],
              cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> logits (B, S, m_vocab) (m-dim when bloom enabled):
    ``x @ embed.T`` for a tied head, else ``x @ head``."""
    w = embed.T if cfg.tie_embeddings else head
    return x @ w.to(x.dtype)


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token CE (...,) in f32 of logits (..., m_vocab) against labels
    (...,).  Bloom: logsumexp(z) - (1/k) sum_j z[H_j(y)] (Eq. 3) through
    the fused Bloom CE; ``valid`` multiplies the loss after it."""
    spec = vocab_spec(cfg)
    logits = logits.float()
    if spec is None:
        return losses.softmax_xent_label(logits, labels, valid)
    loss = ops.bloom_ce(logits, labels, spec)
    return loss if valid is None else loss * valid.to(loss.dtype)


def recover_topk(cfg: ModelConfig, logits: torch.Tensor, topk: int = 16,
                 active: Optional[torch.Tensor] = None):
    """Serving-time vocabulary recovery (paper Sec. 3.2): logits
    (..., m_vocab) -> (scores, token_ids) (..., topk) over the original
    vocab (see ``recover_topk_spec``), through the config's
    ``table_dtype``."""
    return recover_topk_spec(vocab_spec(cfg), logits, topk, active=active,
                             table_dtype=resolved_table_dtype(cfg))


def recover_topk_spec(spec: Optional[BloomSpec], logits: torch.Tensor,
                      topk: int = 16, *,
                      active: Optional[torch.Tensor] = None,
                      table_dtype: Optional[str] = None):
    """Top-k recovery keyed by a BloomSpec: (scores, ids), each
    (..., topk).

    Equal scores resolve to the lowest id, as on every decode path of the
    JAX package.  Bloom spec: log_softmax in f32, then the fused Eq. 3
    decode-topk.  ``spec=None`` (a dense vocab) ranks the logits
    themselves with a stable sort.  ``active`` (...,) bool masks retired
    rows to scores=-inf / ids=0 and lets the kernel skip them.
    ``table_dtype`` (None = legacy f32) stores the logp rows narrow for
    the decode and rehashes in the kernel (``ops.bloom_decode_topk``).
    """
    if spec is None:
        srt, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        scores, ids = srt[..., :topk], order[..., :topk].to(torch.int32)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        scores, ids = ops.bloom_decode_topk(logp, spec, topk, active=active,
                                            table_dtype=table_dtype)
    if active is not None:
        live = active[..., None].to(torch.bool)
        scores = torch.where(live, scores, -torch.inf)
        ids = torch.where(live, ids, 0)
    return scores, ids
