"""Config registry: the retrieval serving presets and the ported model
architectures (``get_config`` / ``get_smoke_config``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_moe_16b, granite_8b,
                                 jamba_v0_1_52b, mamba2_1_3b, olmoe_1b_7b,
                                 phi3_mini_3_8b, qwen1_5_0_5b, qwen3_4b)
from repro_torch.configs.base import (  # noqa: F401
    BloomConfig, MambaConfig, MoEConfig, ModelConfig, ShapeConfig,
    TrainConfig)
from repro_torch.configs.retrieval import (  # noqa: F401
    RETRIEVAL_CONFIGS,
    RetrievalConfig,
    get_retrieval_config,
)

# the JAX package's registry order, ported archs only
ARCH_MODULES = {m.ARCH: m for m in (phi3_mini_3_8b, granite_8b, qwen3_4b,
                                    qwen1_5_0_5b, deepseek_moe_16b,
                                    olmoe_1b_7b, jamba_v0_1_52b,
                                    mamba2_1_3b)}
ARCH_NAMES = tuple(ARCH_MODULES)

# the JAX package's other architectures: the vision-frontend and the
# encoder-decoder families, which wait for ROADMAP A12 items 6-7
UNPORTED_ARCHS = ("pixtral-12b", "whisper-small")


def _module(arch: str):
    if arch in ARCH_MODULES:
        return ARCH_MODULES[arch]
    if arch in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP A12 items 6-7); "
            f"ported: {ARCH_NAMES}")
    raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_NAMES}")


def get_config(arch: str, bloom: bool = True, **overrides) -> ModelConfig:
    cfg = _module(arch).config(bloom=bloom)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
