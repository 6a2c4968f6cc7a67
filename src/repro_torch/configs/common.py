"""Shared helpers for the per-arch config files (copied from the JAX
package's ``configs/common.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import BloomConfig, ModelConfig


def with_bloom(cfg: ModelConfig, enabled: bool = True, m_ratio: float = 0.2,
               k: int = 4) -> ModelConfig:
    """Toggle the paper's IO compression on an arch config."""
    return dataclasses.replace(
        cfg, bloom=BloomConfig(enabled=enabled, m_ratio=m_ratio, k=k))


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Structural-preserving reduction used by per-arch smoke tests."""
    return dataclasses.replace(cfg, **overrides)
