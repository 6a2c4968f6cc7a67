"""qwen3-4b [dense]: qk_norm, GQA.  36L d_model=2560 32H (GQA kv=8,
head_dim=128) d_ff=9728 vocab=151936.  [hf:Qwen/Qwen3-8B; hf]

Largest vocab of the pool — the most paper-representative cell: the
Bloom IO layer removes ~78% of the 151,936-row embedding + head.

Copied from the JAX package's ``configs/qwen3_4b.py``.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, ModelConfig

ARCH = "qwen3-4b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", attn_chunk_q=16,
        attn_chunk_k=16,
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
