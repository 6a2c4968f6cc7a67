"""Config registry: the retrieval serving presets and the model
architectures (``get_config`` / ``get_smoke_config``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_moe_16b, granite_8b,
                                 jamba_v0_1_52b, mamba2_1_3b, olmoe_1b_7b,
                                 phi3_mini_3_8b, pixtral_12b, qwen1_5_0_5b,
                                 qwen3_4b, whisper_small)
from repro_torch.configs.base import (  # noqa: F401
    BloomConfig, MambaConfig, MoEConfig, ModelConfig, ShapeConfig,
    TrainConfig)
from repro_torch.configs.retrieval import (  # noqa: F401
    RETRIEVAL_CONFIGS,
    RetrievalConfig,
    get_retrieval_config,
)

# the JAX package's registry order
ARCH_MODULES = {m.ARCH: m for m in (pixtral_12b, phi3_mini_3_8b,
                                    granite_8b, qwen3_4b, qwen1_5_0_5b,
                                    whisper_small, deepseek_moe_16b,
                                    olmoe_1b_7b, jamba_v0_1_52b,
                                    mamba2_1_3b)}
ARCH_NAMES = tuple(ARCH_MODULES)


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_NAMES}")
    return ARCH_MODULES[arch]


def get_config(arch: str, bloom: bool = True, **overrides) -> ModelConfig:
    cfg = _module(arch).config(bloom=bloom)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
