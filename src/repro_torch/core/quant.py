"""Bitwidth compression for Bloom tables: the ``table_dtype`` knob.

Ported from the JAX package's ``core/quant.py``, the single source of truth
for the knob threaded through the kernels, the configs and the bytes
models:

* ``"float32"`` / ``"bfloat16"`` — plain casts, no scales.
* ``"int8"``     — symmetric per-row quantization: one positive float32
  scale per table row, ``scale[r] = max(max|row_r| / 127, 1e-12)``, values
  rounded half to even and clipped to [-127, 127].  Per ROW because both
  Bloom kernels read whole rows (the embedding's gathered rows, the
  decode's logp rows), so the scale rides the row and dequantization is
  one multiply.
* ``"fp8_e4m3"`` — scale-free cast to ``float8_e4m3fn``, rounded to
  nearest even.  The JAX cast gives NaN where |x| rounds past the largest
  finite value (|x| > 464, and ±inf); PyTorch's cast saturates to ±448
  there, so ``quantize_table`` writes the reference's NaN back in.

Quantization error is bounded elementwise by ``scale/2`` for int8, and the
kernels accumulate in float32: the knob changes the bytes read, not the
accumulation precision.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Canonical knob values.  "auto" is the config-layer default meaning
# "legacy behavior": cast the table to the activation dtype, no
# quantization and no scales.
TABLE_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")

_ALIASES = {"fp32": "float32", "bf16": "bfloat16", "fp8": "fp8_e4m3"}

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1, "fp8_e4m3": 1}

_STORAGE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
}

# above this magnitude an f32 value rounds past 448 (the largest finite
# e4m3fn value; 464 is the tie with the next step, which rounds to even)
_FP8_E4M3_LIMIT = 464.0


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


def storage_dtype(table_dtype: str) -> torch.dtype:
    """The torch dtype a table with this knob is stored (and read) in."""
    return _STORAGE[resolve_table_dtype(table_dtype)]


def storage_name(dtype: torch.dtype) -> str:
    """The knob value whose storage dtype is ``dtype`` (inverse of
    ``storage_dtype``)."""
    for name, st in _STORAGE.items():
        if st == dtype:
            return name
    raise TypeError(f"{dtype} is no table storage dtype; one of "
                    f"{tuple(_STORAGE.values())}")


def _to_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Round to ``float8_e4m3fn`` as the JAX cast does: nearest even, and
    NaN (sign kept) where |x| > 464 or x is infinite, where PyTorch's cast
    saturates to ±448."""
    x = x.float()
    q = x.to(torch.float8_e4m3fn)
    bits = q.view(torch.uint8)
    nan = (bits & 0x80) | 0x7F
    bits = torch.where(x.abs() > _FP8_E4M3_LIMIT, nan, bits)
    return bits.view(torch.float8_e4m3fn)


def quantize_table(table: torch.Tensor, table_dtype: str
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(m, D) float table -> (stored table, per-row float32 scales | None).

    int8 returns ``(q, scales)`` with ``q[r] = round(row_r / scales[r])``
    clipped to [-127, 127] and ``scales[r] = max|row_r| / 127`` (clamped
    to 1e-12 so all-zero rows stay exactly zero instead of dividing by
    zero).  Every other dtype is a cast with ``scales=None``.  Torch ops
    on the table's device: runs in the graph during training (the
    straight-through path) and once per table at serve time
    (core.bloom.cached_quantized_table).
    """
    td = resolve_table_dtype(table_dtype)
    if td == "fp8_e4m3":
        return _to_fp8_e4m3(table), None
    if td != "int8":
        return table.to(_STORAGE[td]), None
    x = table.float()
    amax = x.abs().amax(dim=-1)                                # (m,)
    # divide by a tensor filled on the table's device: on CUDA, PyTorch
    # turns a division by a scalar into a multiply by its reciprocal, which
    # can differ from the reference's division in the last bit
    scales = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(x / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_table(qtable: torch.Tensor,
                     scales: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain oracle of the kernels' dequantization: float32 values."""
    x = qtable.float()
    if scales is not None:
        x = x * scales[:, None].float()
    return x
