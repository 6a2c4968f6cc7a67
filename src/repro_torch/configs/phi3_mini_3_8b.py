"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA.  32L d_model=3072 32H
(GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064.  [arXiv:2404.14219; unverified]

Copied from the JAX package's ``configs/phi3_mini_3_8b.py``.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, ModelConfig

ARCH = "phi3-mini-3.8b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab=32064,
        rope_theta=10_000.0,
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", attn_chunk_q=16,
        attn_chunk_k=16,
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
