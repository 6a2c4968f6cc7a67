"""pixtral-12b [vlm]: Pixtral-ViT frontend (stub) + Mistral-Nemo-style
decoder.  40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336
vocab=131072.  [hf:mistralai/Pixtral-12B-2409; unverified]

Copied from the JAX package's ``configs/pixtral_12b.py``.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, ModelConfig

ARCH = "pixtral-12b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        frontend_frac=0.25,
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
