"""Web-scale Bloom retrieval scenario configs.

The retrieval scenario is NOT a token LM: there is no KV cache and no
autoregressive loop.  A request carries a padded item-id set, prefill
Bloom-encodes it (core.bloom.encode, Eq. 1) and runs a small FF tower
(models/recommender.py) to an m-dim output, and the single recover step
takes the Eq. 3 top-k over the d-item catalog — so the scenario has its own
frozen config describing exactly those pieces.

Scale notes that drive the presets:
  * ``on_the_fly=True`` always: the hash indices are a pure function of
    the spec; the serving decode caches the (d, k) int32 matrix once per
    device (``core.bloom.cached_hash_matrix``, ~80 MB at d = 10M, k = 2),
    or, with a quantized ``table_dtype``, re-derives them in the kernel.
  * the decode's working set is (B, m) plus H; the dense-table oracle it
    replaces needs the full (d, m) table plus a (B, d) score matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.bloom import BloomSpec


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Static description of one retrieval serving scenario."""

    name: str = "retrieval"
    d: int = 1_000_000        # item-catalog size
    m: int = 4096             # Bloom-compressed output dimensionality
    k: int = 2                # hash projections (paper: 2..4 best)
    c_max: int = 8            # input items per request (padded, -1)
    hidden: Tuple[int, ...] = (64, 64)   # FF tower widths
    topk: int = 10            # retrieved items per request
    seed: int = 0             # hash seed AND tower-init seed
    chunk: int = 65536        # vocab chunk of the full-score eval
    b_tile: int = 8           # row block of the reference's TPU bytes model
    table_dtype: str = "auto" # pool-logits storage dtype for the decode:
                              # auto (legacy f32) | float32 | bfloat16 |
                              # int8 | fp8_e4m3; a quantized decode also
                              # re-derives the hash indices in the kernel
                              # (no (d, k) matrix read)

    def __post_init__(self):
        if not (0 < self.m <= self.d):
            raise ValueError(f"need 0 < m <= d, got m={self.m} d={self.d}")
        if not (1 <= self.topk <= self.d):
            raise ValueError(f"need 1 <= topk <= d, got topk={self.topk}")
        if self.c_max < 1:
            raise ValueError(f"need c_max >= 1, got {self.c_max}")
        quant.resolve_table_dtype(self.table_dtype, allow_auto=True)

    def spec(self) -> BloomSpec:
        """The Bloom IO spec; on_the_fly on purpose (see module doc)."""
        return BloomSpec(d=self.d, m=self.m, k=self.k, seed=self.seed,
                         on_the_fly=True)

    @staticmethod
    def resolved_impl(device) -> str:
        """The decode path a pool on ``device`` takes: the CUDA kernel on a
        CUDA device, its plain PyTorch version on the CPU."""
        return "kernel" if torch.device(device).type == "cuda" else "plain"


# Presets: web1m is the mid scale; web10m is the "dense table cannot fit"
# scale (d*m*4 = 320 GB dense); smoke keeps full-score eval affordable.
RETRIEVAL_CONFIGS: Dict[str, RetrievalConfig] = {
    "web1m": RetrievalConfig(name="web1m", d=1_000_000, m=4096, k=2),
    "web10m": RetrievalConfig(name="web10m", d=10_000_000, m=8192, k=2),
    "smoke": RetrievalConfig(name="smoke", d=50_000, m=256, k=2,
                             hidden=(32,), topk=8, chunk=8192),
    # training/eval scale: small enough that the full-score (B, d) ranking
    # eval fits, big enough that an untrained tower's MAP is ~1/d-noise
    "eval2k": RetrievalConfig(name="eval2k", d=2_000, m=400, k=2,
                              hidden=(32,), topk=10, chunk=2048),
}


def get_retrieval_config(name: str, **overrides) -> RetrievalConfig:
    if name not in RETRIEVAL_CONFIGS:
        raise KeyError(f"unknown retrieval config {name!r}; known: "
                       f"{tuple(RETRIEVAL_CONFIGS)}")
    cfg = RETRIEVAL_CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
