"""Bloom embedding: the k-way row gather-sum of the token input, and its
backward.

For a table (m, D) and hash indices idx (T, k) int32 in [0, m):
``out[t, :] = sum_j table[idx[t, j], :]``, summed in f32 in j order and
rounded once to the table's dtype (float32 or bfloat16).  Its gradient is
the CSR scatter-add of the cotangent (``kernels/bloom_csr.py``), rounded
to the table's dtype, as the reference's custom VJP rounds it.

* ``bloom_embed_cuda`` launches the hand-written Hopper kernel
  (``csrc/bloom_embed.cu``, which replaces the JAX package's Pallas
  ``bloom_embed_pallas`` forward) on CUDA tensors, and counts its launches.
* ``bloom_embed_plain`` is the same forward in plain PyTorch on any
  device: the CPU path, and what the kernel is held against on the card.
* ``bloom_embed`` is the differentiable entry: an ``autograd.Function``
  whose forward picks between them by the tensors' device
  (kernels.common.resolve_impl: CUDA tensors launch the kernel or raise)
  and whose backward is ``bloom_csr.csr_scatter_add`` (the CSR kernel on
  CUDA, its plain version on the CPU).  Under ``torch.inference_mode`` it
  launches the forward kernel alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import bloom_csr, common

NAME = "bloom_embed"
DTYPES = (torch.float32, torch.bfloat16)


def min_bytes(n_rows: int, T: int, k: int, D: int, itemsize: int) -> int:
    """The least device-memory traffic of one call: the ``n_rows``
    distinct gathered table rows once, the (T, k) int32 indices once and
    the (T, D) output once."""
    return int(n_rows * D * itemsize + T * k * 4 + T * D * itemsize)


def _check_shapes(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"need table (m, D) and idx (T, k), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.shape[1] < 1:
        raise ValueError("need k >= 1 hash indices per token")


def bloom_embed_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """The plain PyTorch version: (T, D) in table's dtype, on its device."""
    _check_shapes(table, idx)
    h = idx.long()
    acc = table[h[:, 0]].float()
    for j in range(1, h.shape[1]):
        acc = acc + table[h[:, j]].float()
    return acc.to(table.dtype)


def bloom_embed_cuda(table: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream (no sync).

    table (m, D) float32 or bfloat16 and idx (T, k) int32, contiguous, on
    one CUDA device.  Index values are not checked (that would cost a
    device sync): callers pass ``BloomSpec.indices_for`` output, which is
    in [0, m) by construction.  Raises on anything the kernel does not
    take."""
    _check_shapes(table, idx)
    if not (table.is_cuda and idx.is_cuda and table.device == idx.device):
        raise ValueError("table and idx must lie on one CUDA device")
    if table.dtype not in DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"need a float32 or bfloat16 table and int32 idx, "
                        f"got {table.dtype} and {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    (m, D), (T, k) = table.shape, idx.shape
    if T * k >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"need T*k, D < 2**31, got T*k={T * k} D={D}")
    out = torch.empty((T, D), dtype=table.dtype, device=table.device)
    if T == 0 or D == 0:
        return out
    lib = _library()
    fn = (lib.bloom_embed_fwd_f32 if table.dtype == torch.float32
          else lib.bloom_embed_fwd_bf16)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), T, D, k,
             stream)
    if err != 0:
        msg = lib.bloom_embed_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    common.count_launch(NAME)
    return out


class _BloomEmbed(torch.autograd.Function):
    """(T, D) in table's dtype; the backward returns dtable (m, D) in the
    table's dtype."""

    @staticmethod
    def forward(ctx, table, idx):
        if common.resolve_impl(table, idx) == "kernel":
            out = bloom_embed_cuda(table, idx)
        else:
            out = bloom_embed_plain(table, idx)
        ctx.save_for_backward(idx)
        ctx.m, ctx.dtype = table.shape[0], table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        dtable = bloom_csr.csr_scatter_add(g.contiguous(), idx, ctx.m)
        return dtable.to(ctx.dtype), None


def bloom_embed(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in ``table`` through the CSR scatter-add."""
    return _BloomEmbed.apply(table, idx)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = common.load_library(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bloom_embed_fwd_f32, lib.bloom_embed_fwd_bf16):
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = i
    lib.bloom_embed_error_string.argtypes = [i]
    lib.bloom_embed_error_string.restype = ctypes.c_char_p
    return lib
