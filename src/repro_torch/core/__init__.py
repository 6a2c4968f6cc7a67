"""Core: the paper's contribution — Bloom embeddings for sparse binary IO.

  hashing   — double hashing + precomputed hash matrices
  bloom     — BloomSpec, encode (Eq. 1), decode_scores / decode_topk (Eq. 3)
  quant     — the table_dtype knob's names and sizes
"""
from repro_torch.core import hashing  # noqa: F401
from repro_torch.core.bloom import (  # noqa: F401
    BloomSpec,
    identity_spec,
    encode,
    decode_scores,
    decode_topk,
)
