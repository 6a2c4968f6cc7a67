"""Config registry: the retrieval serving presets and the ported model
architectures (``get_config`` / ``get_smoke_config``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen1_5_0_5b
from repro_torch.configs.base import BloomConfig, ModelConfig  # noqa: F401
from repro_torch.configs.retrieval import (  # noqa: F401
    RETRIEVAL_CONFIGS,
    RetrievalConfig,
    get_retrieval_config,
)

ARCH_MODULES = {qwen1_5_0_5b.ARCH: qwen1_5_0_5b}
ARCH_NAMES = tuple(ARCH_MODULES)

# the JAX package's other architectures, which wait for ROADMAP A12
UNPORTED_ARCHS = ("pixtral-12b", "phi3-mini-3.8b", "granite-8b", "qwen3-4b",
                  "whisper-small", "deepseek-moe-16b", "olmoe-1b-7b",
                  "jamba-v0.1-52b", "mamba2-1.3b")


def _module(arch: str):
    if arch in ARCH_MODULES:
        return ARCH_MODULES[arch]
    if arch in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP A12); ported: "
            f"{ARCH_NAMES}")
    raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_NAMES}")


def get_config(arch: str, bloom: bool = True, **overrides) -> ModelConfig:
    cfg = _module(arch).config(bloom=bloom)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
