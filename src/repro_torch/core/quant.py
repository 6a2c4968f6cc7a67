"""Bitwidth compression knob for Bloom tables: names and sizes only.

The ``table_dtype`` knob of the JAX package's ``core/quant.py`` (float32,
bfloat16, int8 with per-row scales, fp8_e4m3).  The port so far serves only
the config default ``"auto"`` (the legacy f32 path, no quantization), so
this module carries the validation and the storage sizes the bytes models
read; ``quantize_table`` arrives with the quantized decode kernel.
"""
from __future__ import annotations

from typing import Optional

# Canonical knob values.  "auto" is the config-layer default meaning
# "legacy behavior": cast the table to the activation dtype, no
# quantization and no scales.
TABLE_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")

_ALIASES = {"fp32": "float32", "bf16": "bfloat16", "fp8": "fp8_e4m3"}

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1, "fp8_e4m3": 1}


def resolve_table_dtype(table_dtype: Optional[str],
                        allow_auto: bool = False) -> Optional[str]:
    """Normalize/validate a ``table_dtype`` knob value.

    Returns the canonical name from TABLE_DTYPES; passes ``None`` through
    (kernel-layer "no quantization requested").  ``allow_auto=True`` also
    accepts the config-layer default ``"auto"``.  Unknown values raise with
    the full menu so CLI typos fail fast.
    """
    if table_dtype is None:
        return None
    if allow_auto and table_dtype == "auto":
        return "auto"
    td = _ALIASES.get(table_dtype, table_dtype)
    if td not in TABLE_DTYPES:
        extra = ("auto", ) if allow_auto else ()
        raise ValueError(
            f"table_dtype must be one of {tuple(extra) + TABLE_DTYPES} "
            f"(aliases: {sorted(_ALIASES)}), got {table_dtype!r}")
    return td


def table_itemsize(table_dtype: Optional[str]) -> int:
    """Bytes per stored table element — the bytes models' single source."""
    if table_dtype is None:
        return 4
    return _ITEMSIZE[resolve_table_dtype(table_dtype)]
