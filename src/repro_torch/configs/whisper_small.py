"""whisper-small [audio]: encoder-decoder, conv frontend STUBBED
(the frames arrive as precomputed embeddings).  12L enc + 12L dec,
d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865.  [arXiv:2212.04356]

Deviation notes: RoPE replaces whisper's sinusoidal/learned positions
(the frontend is a stub anyway); norms are RMSNorm like the rest of the
zoo.  Bloom IO applies to the decoder vocabulary.

Copied from the JAX package's ``configs/whisper_small.py``.
"""
import dataclasses

from repro_torch.configs.base import BloomConfig, ModelConfig

ARCH = "whisper-small"


def config(bloom: bool = True) -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="audio",
        num_layers=12,          # decoder
        encoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        frontend="audio_stub",
        bloom=BloomConfig(enabled=bloom, m_ratio=0.2, k=4),
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab=512, dtype="float32",
        attn_chunk_q=16, attn_chunk_k=16,
        bloom=BloomConfig(enabled=True, m_ratio=0.25, k=3),
    )
