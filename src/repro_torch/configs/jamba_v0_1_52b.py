"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer.  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
[arXiv:2403.19887; hf]

Layout: period-8 super-blocks with attention at offset 4 (1 attn : 7
mamba), MoE FFN on odd layers.  Jamba's attention uses no positional
encoding (use_rope=False); the SSM follows the Mamba-2 SSD block with
Jamba's d_state=16 (the JAX package's Mamba-1 -> SSD substitution).

Copied from the JAX package's ``configs/jamba_v0_1_52b.py``; the smoke
variant leaves ``moe_impl`` at its default, "dense", as the reference's
sets it.
"""
import dataclasses

from repro_torch.configs.base import (BloomConfig, MambaConfig, MoEConfig,
                                      ModelConfig)

ARCH = "jamba-v0.1-52b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=65536,
        use_rope=False,
        attn_layer_period=8,
        attn_layer_offset=4,
        moe=MoEConfig(num_experts=16, top_k=2, num_shared=0,
                      d_ff_expert=14336),
        moe_layer_period=2,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                          chunk=256),
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", attn_chunk_q=16,
        attn_chunk_k=16,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared=0, d_ff_expert=64,
                      capacity_factor=8.0),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                          chunk=8),
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
