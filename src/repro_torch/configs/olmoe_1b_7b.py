"""olmoe-1b-7b [moe]: 64 experts top-8, no shared.  16L d_model=2048 16H
(MHA kv=16) d_ff(expert)=1024 vocab=50304.  [arXiv:2409.02060; hf]

Copied from the JAX package's ``configs/olmoe_1b_7b.py``; the smoke
variant leaves ``moe_impl`` at its default, "dense", as the reference's
sets it.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, MoEConfig, ModelConfig

ARCH = "olmoe-1b-7b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab=50304,
        moe=MoEConfig(num_experts=64, top_k=8, num_shared=0,
                      d_ff_expert=1024),
        moe_layer_period=1,
        rope_theta=10_000.0,
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab=512, dtype="float32", attn_chunk_q=16,
        attn_chunk_k=16,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=0, d_ff_expert=32,
                      capacity_factor=8.0),
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
