"""qwen1.5-0.5b [dense]: QKV bias, tied embeddings.  24L d_model=1024 16H
(MHA kv=16) d_ff=2816 vocab=151936.  [hf:Qwen/Qwen1.5-0.5B; hf]

Vocab-dominated model: the 151,936 x 1024 embedding is ~34% of all
parameters — the paper's '99.9%' regime scaled to 2024; Bloom IO at
m/d=0.2 removes ~27% of the entire model.

Copied from the JAX package's ``configs/qwen1_5_0_5b.py``; the smoke
variant drops only the reference's attention chunk sizes, which the port
has no field for.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, ModelConfig

ARCH = "qwen1.5-0.5b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, dtype="float32",
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
