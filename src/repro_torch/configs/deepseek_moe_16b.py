"""deepseek-moe-16b [moe]: fine-grained experts — 2 shared + 64 routed
top-6.  28L d_model=2048 16H (MHA kv=16) d_ff(expert)=1408 vocab=102400.
[arXiv:2401.06066; hf]

Simplification note (as in the JAX package): the HF model's dense first
layer is made MoE like the rest so every layer has the same roles;
expert dims follow the assignment.

Copied from the JAX package's ``configs/deepseek_moe_16b.py``; the smoke
variant leaves ``moe_impl`` at its default, "dense", as the reference's
sets it.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, MoEConfig, ModelConfig

ARCH = "deepseek-moe-16b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=102400,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                      d_ff_expert=1408),
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
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_ff_expert=32,
                      capacity_factor=8.0),
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
