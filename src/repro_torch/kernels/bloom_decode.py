"""Bloom vocabulary recovery (Eq. 3) over the whole vocabulary, forward and
backward.

    forward   scores[b, i] = sum_j row_b[H[i, j]]                  (B, d) f32
    backward  dlogp[b, c]  = sum over (i, j) with H[i, j] == c of g[b, i]

``row_b`` is logp row b as f32; logp may be stored narrow (``table_dtype``,
core/quant.py) as bf16 or fp8 e4m3 (widened), or int8 with one f32 scale
per row, where the scores are ``(sum_j q[b, H[i, j]]) * scales[b]``: the
raw int8 values summed (exactly, in f32) and scaled once per output, as
the reference's ``_fwd_kernel_scaled`` does.  Sums run in f32 in j order.

* ``bloom_decode_cuda`` launches the hand-written Hopper kernel
  (``csrc/bloom_decode.cu``, which replaces the JAX package's Pallas
  ``bloom_decode_pallas`` and its int8 ``_fwd_kernel_scaled``) and counts
  it as ``bloom_decode`` (f32 logp) or ``bloom_decode.<storage>``;
  ``bloom_decode_plain`` is the same function in plain PyTorch
  (``ref.bloom_decode_ref``, and its (sum q) * s form for int8).
* ``bloom_decode_bwd_cuda`` is the dense backward (replaces
  ``bloom_decode_bwd_pallas``), counted as ``bloom_decode_bwd``: it bins H
  on the card on every call (``bloom_csr.bin_csr_cuda``, counted as
  ``bloom_csr.bin``; never the spec's cached bins, which is what separates
  it from ``bwd_impl="csr"``), then runs the CSR scatter-add kernel
  (``csrc/bloom_csr.cu``) on the transposed (d, B) cotangent.  It sums
  each output over i ascending from 0.0 with no float atomics, the order
  of the CSR bins, so it equals the CSR decode backward
  (``bloom_csr.bloom_decode_bwd_csr``) bit for bit.
  ``bloom_decode_bwd_plain`` is ``zeros(m, B).index_add_`` over H's
  entries in (i, j) order, transposed: on the CPU, where ``index_add_``
  adds in index order, the kernel's sum order.
* ``bloom_decode`` is the differentiable entry: an ``autograd.Function``
  whose forward picks kernel or plain version by the tensors' device,
  quantizing logp first when ``table_dtype`` is given, and whose backward
  is the CSR scatter-add (``bwd_impl="csr"``, with bins from ``bins_fn``
  when given) or the dense kernel (``"dense"``).  Gradients are
  straight-through under ``table_dtype`` and come back in logp's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import bloom_csr, common, ref

NAME = "bloom_decode"
BWD = "bloom_decode_bwd"
# the kernel stages one logp row in shared memory as f32 (227 KB per block)
MAX_M = 56 * 1024
# shared memory of one SM on sm_90a and what a block takes beyond its row
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK_EXTRA = 2048
# the logp storage dtype codes of csrc/bloom_decode.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}


def variant_name(dtype: torch.dtype) -> str:
    """Launch-count name of the forward on logp stored as ``dtype``."""
    if dtype == torch.float32:
        return NAME
    return f"{NAME}.{quant.storage_name(dtype)}"


def min_bytes(B: int, m: int, d: int, k: int, logp_itemsize: int = 4,
              row_scales: bool = False) -> int:
    """The least device-memory traffic of one forward: H once, each logp
    row once (and its f32 scale for int8), the (B, d) f32 scores once.
    The dense backward moves the same bytes at ``logp_itemsize=4``: the
    (B, d) cotangent and H in, the (B, m) f32 gradient out."""
    return int(d * k * 4 + B * (m * logp_itemsize + (4 if row_scales else 0))
               + B * d * 4)


def _check(logp: torch.Tensor, H: torch.Tensor,
           scales: Optional[torch.Tensor]) -> None:
    if logp.ndim != 2 or H.ndim != 2:
        raise ValueError(f"need logp (B, m) and H (d, k), got "
                         f"{tuple(logp.shape)} and {tuple(H.shape)}")
    if logp.dtype not in _CODES:
        raise TypeError(f"logp must be stored as one of {tuple(_CODES)}, "
                        f"got {logp.dtype}")
    if (scales is not None) != (logp.dtype == torch.int8):
        raise ValueError("int8 logp needs its (B,) row scales, and only "
                         "int8 logp takes scales")
    if scales is not None and (scales.dtype != torch.float32 or
                               tuple(scales.shape) != (logp.shape[0],)):
        raise ValueError(f"scales must be ({logp.shape[0]},) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")


def bloom_decode_plain(logp: torch.Tensor, H: torch.Tensor,
                       scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The plain PyTorch forward: (B, d) f32 on logp's device."""
    _check(logp, H, scales)
    if scales is not None:
        return ref.bloom_decode_scaled_ref(logp, scales, H)
    return ref.bloom_decode_ref(logp.float(), H)


def bloom_decode_cuda(logp: torch.Tensor, H: torch.Tensor,
                      scales: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream (no sync).

    logp (B, m) float32, bfloat16, int8 (with (B,) f32 ``scales``) or
    float8_e4m3fn; H (d, k) int32 in [0, m); contiguous, on one CUDA
    device.  Raises on anything the kernel does not take, and when a logp
    row does not fit in shared memory (m > MAX_M)."""
    _check(logp, H, scales)
    tensors = [t for t in (logp, H, scales) if t is not None]
    if not all(t.is_cuda and t.device == logp.device for t in tensors):
        raise ValueError("logp, H and scales must lie on one CUDA device")
    if H.dtype != torch.int32:
        raise TypeError(f"need int32 H, got {H.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("logp, H and scales must be contiguous")
    (B, m), (d, k) = logp.shape, H.shape
    if m > MAX_M:
        raise ValueError(f"m={m} exceeds the kernel's shared-memory row "
                         f"({MAX_M} floats)")
    if B >= 65536 or d * k >= 2 ** 31:
        raise ValueError(f"need B < 65536 and d*k < 2**31, got B={B} "
                         f"d*k={d * k}")
    out = torch.empty((B, d), dtype=torch.float32, device=logp.device)
    if B and d:
        lib = _library()
        err = lib.bloom_decode_fwd(
            logp.data_ptr(), _CODES[logp.dtype],
            None if scales is None else scales.data_ptr(), H.data_ptr(),
            out.data_ptr(), B, m, d, k, _groups(logp.device, B, d, m),
            torch.cuda.current_stream(logp.device).cuda_stream)
        _raise_on(lib, err)
        common.count_launch(variant_name(logp.dtype))
    return out


def bloom_decode_fwd(logp: torch.Tensor, H: torch.Tensor,
                     scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if common.resolve_impl(logp, H, scales) == "kernel":
        return bloom_decode_cuda(logp, H, scales)
    return bloom_decode_plain(logp, H, scales)


def _check_bwd(g: torch.Tensor, H: torch.Tensor) -> None:
    if g.ndim != 2 or H.ndim != 2 or g.shape[1] != H.shape[0]:
        raise ValueError(f"need g (B, d) and H (d, k), got "
                         f"{tuple(g.shape)} and {tuple(H.shape)}")


def bloom_decode_bwd_plain(g: torch.Tensor, H: torch.Tensor,
                           m: int) -> torch.Tensor:
    """The plain PyTorch dense backward: (B, m) f32 on g's device, each
    output summed over H's entries in (i, j) order (on the CPU; on a CUDA
    tensor ``index_add_`` adds with atomics).  Entries outside [0, m)
    never match (they add into a spare row m that is cut off)."""
    _check_bwd(g, H)
    d, k = H.shape
    flat = H.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < m), flat, m)
    src = torch.arange(d, device=g.device).repeat_interleave(k)
    out = torch.zeros(m + 1, g.shape[0], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, flat, g.float().t()[src])[:m].t()


def bloom_decode_bwd_cuda(g: torch.Tensor, H: torch.Tensor,
                          m: int) -> torch.Tensor:
    """Bin H and launch the scatter-add on PyTorch's current stream (no
    sync).  g (B, d) float32 and H (d, k) int32, contiguous, on one CUDA
    device; (B, m) f32 (the transpose of the kernel's (m, B) output)."""
    _check_bwd(g, H)
    if not (g.is_cuda and H.device == g.device):
        raise ValueError("g and H must lie on one CUDA device")
    if g.dtype != torch.float32 or H.dtype != torch.int32:
        raise TypeError(f"need a float32 g and int32 H, got {g.dtype} and "
                        f"{H.dtype}")
    if not (g.is_contiguous() and H.is_contiguous()):
        raise ValueError("g and H must be contiguous")
    B = g.shape[0]
    if not (B and m):
        return torch.empty((B, m), dtype=torch.float32, device=g.device)
    bins = bloom_csr.bin_csr_cuda(H, m)
    return bloom_csr.csr_scatter_add_cuda(g.t().contiguous(), bins, m,
                                          BWD).t()


def bloom_decode_bwd(g: torch.Tensor, H: torch.Tensor, m: int
                     ) -> torch.Tensor:
    """The dense backward: the kernel for CUDA tensors, the plain version
    for CPU tensors.  (B, m) f32."""
    if common.resolve_impl(g, H) == "kernel":
        return bloom_decode_bwd_cuda(g, H, m)
    return bloom_decode_bwd_plain(g, H, m)


class _BloomDecode(torch.autograd.Function):
    """(B, d) f32 scores; the backward returns dlogp (B, m) in logp's
    dtype (straight-through when the forward was quantized)."""

    @staticmethod
    def forward(ctx, logp, H, bwd_impl, table_dtype, bins_fn):
        if table_dtype is None:
            x, scales = (logp if logp.dtype in (torch.float32,
                                                torch.bfloat16)
                         else logp.float()), None
        else:
            x, scales = quant.quantize_table(logp, table_dtype)
        ctx.save_for_backward(H)
        ctx.m, ctx.dtype = logp.shape[1], logp.dtype
        ctx.bwd_impl, ctx.bins_fn = bwd_impl, bins_fn
        return bloom_decode_fwd(x.contiguous(), H, scales)

    @staticmethod
    def backward(ctx, g):
        H, = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.bwd_impl == "csr":
            bins = ctx.bins_fn() if ctx.bins_fn is not None else None
            dlogp = bloom_csr.bloom_decode_bwd_csr(g, H, ctx.m, bins)
        else:
            dlogp = bloom_decode_bwd(g, H, ctx.m)
        return dlogp.to(ctx.dtype), None, None, None, None


def bloom_decode(logp: torch.Tensor, H: torch.Tensor, bwd_impl: str = "csr",
                 table_dtype: Optional[str] = None,
                 bins_fn: Optional[Callable] = None) -> torch.Tensor:
    """logp (B, m) float; H (d, k) int32 -> scores (B, d) float32: the
    kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in ``logp``.

    ``bwd_impl`` picks the backward: "csr" (the CSR scatter-add on the
    transposed cotangent; ``bins_fn``, a zero-argument callable returning
    ``bloom_csr.bin_csr(H, m)``, is called only in the backward, else H is
    binned there) or "dense" (H binned on the card per call, then the
    same scatter-add).  ``table_dtype``
    (core/quant.py) quantizes logp per call for the kernel to read narrow;
    its gradient is straight-through."""
    common.resolve_bwd_impl(bwd_impl)
    return _BloomDecode.apply(logp, H, bwd_impl,
                              quant.resolve_table_dtype(table_dtype),
                              bins_fn)


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.bloom_decode_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def _groups(device: torch.device, B: int, d: int, m: int) -> int:
    """Blocks per row of the forward: one wave when every row's blocks fit
    (as many as share an SM by the row's shared memory), no more than
    256-id tiles."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(4, SMEM_PER_SM // (m * 4 + SMEM_PER_BLOCK_EXTRA)))
    return max(1, min(-(-d // 256), per_sm * n_sm // B, 65535))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = common.load_library(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bloom_decode_fwd.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.bloom_decode_fwd.restype = i
    lib.bloom_decode_error_string.argtypes = [i]
    lib.bloom_decode_error_string.restype = ctypes.c_char_p
    return lib
