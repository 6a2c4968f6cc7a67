"""Roofline analysis at the H100's rates.

Per (arch x shape x mesh) the dry run (launch/dryrun.py) counts one rank's
step and this module turns the counts into three times:

  compute    = FLOPs_per_rank / PEAK_FLOPS              [s]
  memory     = bytes_per_rank / HBM_BW                  [s]
  collective = collective_bytes_per_rank / LINK_BW      [s]

The JAX package reads its FLOPs and bytes from XLA's cost analysis and
its collectives from the partitioned HLO text.  The port has no HLO: the
dry run counts FLOPs with ``torch.utils.flop_counter``, bytes with a
dispatch mode, and the collectives as the step calls them (a counting
transport), each call with its kind, result bytes, operand bytes and
group size; ``ring_collectives`` applies the reference's ring formulas
to that list.  ``active_param_count`` and ``model_flops`` (the analytic
6·N·D model FLOPs) are the reference's config arithmetic, copied.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

from repro_torch.configs.base import ModelConfig, ShapeConfig

# H100 SXM5, one card (NVIDIA H100 Tensor Core GPU data sheet):
# dense bf16 tensor-core peak, 1,979 TFLOPS with sparsity halved
PEAK_FLOPS = 989.4e12
# HBM3 bandwidth
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s a card in both directions, 450 GB/s each way
LINK_BW = 450e9
# f32 outside the tensor cores (the bound of a kernel's f32 arithmetic)
F32_PEAK_FLOPS = 67e12
# int32 outside the tensor cores: 132 SMs x 64 INT32 lanes per SM per
# clock (4 sub-partitions of 16) x 1.98 GHz, the maximum boost clock
# (NVIDIA's Hopper white paper and data sheet)
INT32_PEAK_OPS = 132 * 64 * 1.98e9

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def ring_bytes(kind: str, result_bytes: float, operand_bytes: float,
               group: int) -> float:
    """Bytes one rank moves over its links for one collective, by the
    reference's ring models (``parse_collectives``):

      all-reduce: 2 * size * (g-1)/g        (reduce-scatter + all-gather)
      all-gather: out_size * (g-1)/g
      reduce-scatter: in_size * (g-1)/g
      all-to-all: size * (g-1)/g
      collective-permute: size (one hop)
    """
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2 * result_bytes * frac
    if kind == "all-gather":
        return result_bytes * frac
    if kind in ("reduce-scatter", "all-to-all"):
        return max(operand_bytes, result_bytes) * frac
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective kind {kind!r}; known: "
                     f"{COLLECTIVE_KINDS}")


def ring_collectives(calls: Iterable[Mapping]) -> Dict[str, Dict]:
    """The reference's ``parse_collectives`` result for the collective
    calls of one step: each call a mapping with ``kind`` (a
    ``COLLECTIVE_KINDS`` name), ``result_bytes``, ``operand_bytes`` and
    ``group`` (ranks in the group).  Returns {"per_kind": {kind:
    {"count", "bytes"}}, "total_bytes"}, bytes per rank."""
    per_kind: Dict[str, Dict] = {}
    total = 0.0
    for c in calls:
        moved = ring_bytes(c["kind"], c["result_bytes"], c["operand_bytes"],
                           c["group"])
        k = per_kind.setdefault(c["kind"], {"count": 0, "bytes": 0.0})
        k["count"] += 1
        k["bytes"] += moved
        total += moved
    return {"per_kind": per_kind, "total_bytes": total}


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_bytes_dev: float) -> Dict[str, float]:
    """The three times of one rank's step, the dominant one, the
    no-overlap bound (their largest) and the compute share of it."""
    compute = flops_dev / PEAK_FLOPS
    memory = bytes_dev / HBM_BW
    collective = coll_bytes_dev / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["step_time_s"] = bound          # no-overlap upper bound
    terms["roofline_fraction"] = (compute / bound) if bound > 0 else 0.0
    return terms


# --------------------------------------------------------------------------
# Analytic MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE)
# --------------------------------------------------------------------------

def active_param_count(cfg: ModelConfig) -> int:
    """Matmul-active params per token: excludes the input embedding table
    (gather, not matmul) and the non-selected experts."""
    n = cfg.param_count()
    # subtract embedding table (m_vocab x D); the LM head stays (matmul).
    n -= cfg.m_vocab * cfg.d_model
    if cfg.tie_embeddings:
        n += cfg.m_vocab * cfg.d_model  # tied: the head matmul is real
    if cfg.moe is not None:
        mo = cfg.moe
        n_moe_layers = sum(
            1 for li in range(cfg.num_layers) if cfg._layer_is_moe(li))
        per_expert = 3 * cfg.d_model * mo.d_ff_expert
        inactive = (mo.num_experts - mo.top_k) * per_expert
        n -= n_moe_layers * inactive
    return int(n)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-model FLOPs per step (global, all ranks)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "audio":
            tokens = shape.global_batch * (shape.seq_len
                                           + max(shape.seq_len // 4, 16))
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "audio":
            tokens = shape.global_batch * (shape.seq_len
                                           + max(shape.seq_len // 4, 16))
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention KV-cache reads (flops side
    # of the cache dot-products)
    flops = 2.0 * n_active * shape.global_batch
    n_attn = sum(1 for li in range(cfg.num_layers)
                 if cfg._layer_is_attention(li))
    hd = cfg.resolved_head_dim
    kv_dot = (4.0 * shape.global_batch * shape.seq_len
              * cfg.num_heads * hd)
    return flops + n_attn * kv_dot
