"""Bloom embedding: the k-way row gather-sum of the token input, and its
backward.

For a table (m, D) and hash indices idx (T, k) int32 in [0, m):
``out[t, :] = sum_j row(idx[t, j])``, summed in f32 in j order from row 0
and rounded once to the output dtype.  ``row(r)`` is the table's row r
widened to f32; a quantized table (``table_dtype``, core/quant.py) stores
rows narrow — bf16, fp8 e4m3, or int8 with one f32 scale per row, where
``row(r) = q[r] * scales[r]``.  The gradient is the CSR scatter-add of the
cotangent (``kernels/bloom_csr.py``) into the master table's dtype: with a
quantized forward it is straight-through (the exact gradient of the
unquantized gather-sum), as the reference's custom VJP does.

* ``bloom_embed_cuda`` / ``bloom_embed_quantized_cuda`` launch the
  hand-written Hopper kernel (``csrc/bloom_embed.cu``, which replaces the
  JAX package's Pallas ``bloom_embed_pallas`` forward and its quantized
  ``_fwd_kernel_scaled`` / ``bloom_embed_fwd_quantized``) on CUDA tensors,
  and count their launches: ``bloom_embed`` for a table read as it is
  (output in its dtype), ``bloom_embed.<storage>`` for a quantized one.
* ``bloom_embed_plain`` / ``bloom_embed_quantized_plain`` are the same
  forwards in plain PyTorch on any device: the CPU path, and what the
  kernel is held against on the card.
* ``bloom_embed_fwd_quantized`` is the forward-only serving entry on a
  pre-quantized table (``core.bloom.cached_quantized_table``).
* ``bloom_embed`` is the differentiable entry: an ``autograd.Function``
  whose forward picks kernel or plain version by the tensors' device
  (kernels.common.resolve_impl: CUDA tensors launch the kernel or raise),
  quantizing the table first when ``table_dtype`` is given, and whose
  backward is ``bloom_csr.csr_scatter_add`` (the CSR kernel on CUDA, its
  plain version on the CPU).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import bloom_csr, common

NAME = "bloom_embed"
DTYPES = (torch.float32, torch.bfloat16)     # also the output dtypes
# the storage dtype codes of csrc/bloom_embed.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}


def min_bytes(n_rows: int, T: int, k: int, D: int, itemsize: int,
              out_itemsize: Optional[int] = None,
              row_scales: bool = False) -> int:
    """The least device-memory traffic of one call: the ``n_rows``
    distinct gathered table rows once (at the stored ``itemsize``, plus one
    f32 scale each for int8), the (T, k) int32 indices once and the (T, D)
    output once (at ``out_itemsize``, default ``itemsize``)."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    return int(n_rows * D * itemsize + (n_rows * 4 if row_scales else 0)
               + T * k * 4 + T * D * out_itemsize)


def variant_name(qtable_dtype: torch.dtype) -> str:
    """Launch-count name of the quantized forward on this storage."""
    return f"{NAME}.{quant.storage_name(qtable_dtype)}"


def _check_shapes(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"need table (m, D) and idx (T, k), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.shape[1] < 1:
        raise ValueError("need k >= 1 hash indices per token")


def _check_quantized(qtable: torch.Tensor, scales: Optional[torch.Tensor],
                     idx: torch.Tensor, out_dtype: torch.dtype) -> None:
    _check_shapes(qtable, idx)
    if qtable.dtype not in _CODES:
        raise TypeError(f"need a table stored as one of "
                        f"{tuple(_CODES)}, got {qtable.dtype}")
    if (scales is not None) != (qtable.dtype == torch.int8):
        raise ValueError("an int8 table needs its (m,) scales, and only an "
                         "int8 table takes scales")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (qtable.shape[0],)):
        raise ValueError(f"scales must be ({qtable.shape[0]},) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype must be one of {DTYPES}, got "
                        f"{out_dtype}")


def bloom_embed_quantized_plain(qtable: torch.Tensor,
                                scales: Optional[torch.Tensor],
                                idx: torch.Tensor,
                                out_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """The plain PyTorch version over a stored table: (T, D) in
    ``out_dtype``, on the table's device.  ``scales`` (m,) f32 for an int8
    table, None otherwise."""
    _check_quantized(qtable, scales, idx, out_dtype)
    h = idx.long()

    def row(j):
        r = qtable[h[:, j]].float()
        return r if scales is None else r * scales[h[:, j]][:, None]

    acc = row(0)
    for j in range(1, h.shape[1]):
        acc = acc + row(j)
    return acc.to(out_dtype)


def bloom_embed_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """The plain PyTorch version: (T, D) in table's dtype (float32 or
    bfloat16), on its device."""
    return bloom_embed_quantized_plain(table, None, idx, table.dtype)


def _launch(qtable: torch.Tensor, scales: Optional[torch.Tensor],
            idx: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Check the tensors, allocate the output and launch on the current
    stream (no sync); counts nothing."""
    tensors = (qtable, idx) if scales is None else (qtable, idx, scales)
    if not all(t.is_cuda and t.device == qtable.device for t in tensors):
        raise ValueError("table, scales and idx must lie on one CUDA device")
    if idx.dtype != torch.int32:
        raise TypeError(f"need int32 idx, got {idx.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, scales and idx must be contiguous")
    (m, D), (T, k) = qtable.shape, idx.shape
    if T * k >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"need T*k, D < 2**31, got T*k={T * k} D={D}")
    out = torch.empty((T, D), dtype=out_dtype, device=qtable.device)
    if T == 0 or D == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(qtable.device).cuda_stream
    err = lib.bloom_embed_fwd(
        qtable.data_ptr(), None if scales is None else scales.data_ptr(),
        idx.data_ptr(), out.data_ptr(), T, D, k, _CODES[qtable.dtype],
        _CODES[out_dtype], stream)
    if err != 0:
        msg = lib.bloom_embed_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    return out


def bloom_embed_cuda(table: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream (no sync).

    table (m, D) float32 or bfloat16 and idx (T, k) int32, contiguous, on
    one CUDA device; the output is in table's dtype.  Index values are not
    checked (that would cost a device sync): callers pass
    ``BloomSpec.indices_for`` output, which is in [0, m) by construction.
    Raises on anything the kernel does not take."""
    _check_shapes(table, idx)
    if table.dtype not in DTYPES:
        raise TypeError(f"need a float32 or bfloat16 table, got "
                        f"{table.dtype}")
    out = _launch(table, None, idx, table.dtype)
    common.count_launch(NAME)
    return out


def bloom_embed_quantized_cuda(qtable: torch.Tensor,
                               scales: Optional[torch.Tensor],
                               idx: torch.Tensor,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Launch the Hopper kernel over a stored table (float32, bfloat16,
    int8 with (m,) f32 ``scales``, or float8_e4m3fn), output in
    ``out_dtype`` (float32 or bfloat16); counted as
    ``bloom_embed.<storage>``.  Raises on anything the kernel does not
    take."""
    _check_quantized(qtable, scales, idx, out_dtype)
    out = _launch(qtable, scales, idx, out_dtype)
    common.count_launch(variant_name(qtable.dtype))
    return out


def bloom_embed_fwd_quantized(qtable: torch.Tensor,
                              scales: Optional[torch.Tensor],
                              idx: torch.Tensor,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Forward-only gather-sum on a PRE-quantized table: the kernel for
    CUDA tensors, the plain version for CPU tensors.  The serving entry:
    callers with frozen params quantize once
    (core.bloom.cached_quantized_table) and pass ``(qtable, scales)``
    here."""
    if common.resolve_impl(qtable, scales, idx) == "kernel":
        return bloom_embed_quantized_cuda(qtable, scales, idx, out_dtype)
    return bloom_embed_quantized_plain(qtable, scales, idx, out_dtype)


def default_out_dtype(table_dtype: Optional[str],
                      table: torch.Tensor) -> torch.dtype:
    """The output dtype when the caller leaves it implicit: the table's
    own without quantization; f32 or bf16 storage keeps its dtype; the
    1-byte storages widen to f32 (the reference's ``_default_out_dtype``)."""
    if table_dtype is None:
        return table.dtype
    st = quant.storage_dtype(table_dtype)
    return st if st in DTYPES else torch.float32


class _BloomEmbed(torch.autograd.Function):
    """(T, D) forward; the backward returns dtable (m, D) in the master
    table's dtype (straight-through when the forward was quantized)."""

    @staticmethod
    def forward(ctx, table, idx, table_dtype, out_dtype):
        if table_dtype is None:
            if common.resolve_impl(table, idx) == "kernel":
                out = bloom_embed_cuda(table, idx)
            else:
                out = bloom_embed_plain(table, idx)
        else:
            qtable, scales = quant.quantize_table(table, table_dtype)
            out = bloom_embed_fwd_quantized(
                qtable, scales, idx,
                out_dtype or default_out_dtype(table_dtype, table))
        ctx.save_for_backward(idx)
        ctx.m, ctx.dtype = table.shape[0], table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        dtable = bloom_csr.csr_scatter_add(g.contiguous(), idx, ctx.m)
        return dtable.to(ctx.dtype), None, None, None


def bloom_embed(table: torch.Tensor, idx: torch.Tensor,
                table_dtype: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in ``table`` through the CSR scatter-add.

    ``table_dtype`` (core/quant.py) quantizes the table in the graph and
    gathers the stored rows (straight-through gradient into ``table``);
    ``out_dtype`` sets the output dtype (default ``default_out_dtype``)."""
    td = quant.resolve_table_dtype(table_dtype)
    if td is None and out_dtype not in (None, table.dtype):
        raise ValueError("out_dtype other than the table's needs a "
                         "table_dtype")
    return _BloomEmbed.apply(table, idx, td, out_dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = common.load_library(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bloom_embed_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.bloom_embed_fwd.restype = i
    lib.bloom_embed_error_string.argtypes = [i]
    lib.bloom_embed_error_string.restype = ctypes.c_char_p
    return lib
