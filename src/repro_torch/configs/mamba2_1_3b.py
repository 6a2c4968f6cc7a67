"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128.  [arXiv:2405.21060]

expand=2 => d_inner=4096; head_dim=64 => 64 heads.  No FFN (mixer-only
blocks, as in the Mamba-2 reference).  Decode state is O(1) in context.

Copied from the JAX package's ``configs/mamba2_1_3b.py``.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, MambaConfig, ModelConfig

ARCH = "mamba2-1.3b"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=1,            # unused (attention-free)
        num_kv_heads=1,
        d_ff=0,
        vocab=50280,
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                          chunk=256),
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2, d_model=64, vocab=512, dtype="float32",
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                          chunk=8),
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
