"""Config registry: the retrieval serving presets, the model
architectures (``get_config`` / ``get_smoke_config``), the four input-shape
cells and the cell grid (``cell_is_runnable``, ``all_cells``), and the
stand-ins of a cell's inputs and decode caches on the ``meta`` device
(``input_specs``, ``cache_specs``): the counterpart of the reference's
``ShapeDtypeStruct``s, shapes and dtypes with no storage."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs import (deepseek_moe_16b, granite_8b,
                                 jamba_v0_1_52b, mamba2_1_3b, olmoe_1b_7b,
                                 phi3_mini_3_8b, pixtral_12b, qwen1_5_0_5b,
                                 qwen3_4b, whisper_small)
from repro_torch.configs.base import (  # noqa: F401
    SHAPE_BY_NAME, SHAPES, BloomConfig, MambaConfig, MeshConfig, MoEConfig,
    ModelConfig, ShapeConfig, TrainConfig)
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


# --------------------------------------------------------------------------
# Cell grid: which (arch x shape) pairs run
# --------------------------------------------------------------------------

def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> tuple[bool, str]:
    """long_500k needs sub-quadratic context cost; only ssm/hybrid run it."""
    if shape.name == "long_500k" and cfg.has_full_attention:
        return False, ("skip: full quadratic attention at 524k context "
                       "(documented in DESIGN.md §5)")
    return True, ""


def all_cells():
    """Yield (arch, shape, runnable, reason) for the 40-cell grid."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, reason = cell_is_runnable(cfg, shape)
            yield arch, shape.name, ok, reason


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Model inputs for one cell as ``meta`` tensors (no storage).

    train/prefill: token (and stub-embedding) sequences; decode: one new
    token (the caches are ``cache_specs``).  vlm reserves
    ``frontend_frac`` of the sequence for patch embeddings; audio takes
    seq_len encoder frames and seq_len // 4 (at least 16) decoder
    tokens."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), i32)}
    if cfg.family == "vlm":
        s_img = int(S * cfg.frontend_frac)
        return {"tokens": _meta((B, S - s_img), i32),
                "embeds": _meta((B, s_img, cfg.d_model), bf16)}
    if cfg.family == "audio":
        return {"tokens": _meta((B, max(S // 4, 16)), i32),
                "embeds": _meta((B, S, cfg.d_model), bf16)}
    return {"tokens": _meta((B, S), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The cell's decode caches as ``meta`` tensors: the family's own
    ``init_lm_cache`` / ``init_encdec_cache`` (1,500 encoder frames,
    whisper's 30 s) on the ``meta`` device."""
    from repro_torch.models import encdec as encdec_lib
    from repro_torch.models import transformer as tf
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return encdec_lib.init_encdec_cache(cfg, B, S, 1500, device="meta")
    return tf.init_lm_cache(cfg, B, S, device="meta")
