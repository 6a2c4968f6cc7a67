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
  it as ``bloom_decode`` (f32 logp) or ``bloom_decode.<storage>``; its
  grid comes from ``plan`` (row tiles of 4 / itemsize rows, one wave of
  id ranges), which the CPU tests reach;
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
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import bloom_csr, common, ref

NAME = "bloom_decode"
BWD = "bloom_decode_bwd"
# the kernel stages a row tile in shared memory at one 32-bit word an index
# (227 KB a block)
MAX_M = 56 * 1024
# shared memory one block may take on sm_90a (H100, H200), and the
# kernel's static shared memory (none)
SMEM_LIMIT = 232_448
SMEM_STATIC = 0
# ids a thread scores a step, and threads a block (csrc/bloom_decode.cu)
IDS_PER_THREAD, THREADS = 4, 512
# the plan gives a block at least MIN_IDS ids (half a step of the block),
# so that staging a row tile (121 KB at m = 30,208) is spread over enough
# gathers; below that it fills one wave of the card.  kernels/sweep_decode
# times 1,024 to 16,384 (PERF.md)
MIN_IDS = IDS_PER_THREAD * THREADS // 2
# the logp storage dtype codes of csrc/bloom_decode.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}


class Plan(NamedTuple):
    """How one forward lays out on the card: ``rows`` logp rows a tile
    (4 / itemsize: 1 f32, 2 bf16, 4 int8 or fp8), ``tiles`` row tiles,
    ``groups`` id ranges a tile of ``chunk`` ids each (a multiple of 4),
    ``grid`` = tiles * groups blocks of ``THREADS``, each with ``smem``
    bytes of dynamic shared memory (the tile, m words)."""
    rows: int
    tiles: int
    groups: int
    chunk: int
    grid: int
    smem: int


def plan(B: int, m: int, d: int, k: int, itemsize: int, n_sm: int,
         min_ids: int = MIN_IDS) -> Plan:
    """The launch plan of a forward on (B, m) logp stored ``itemsize``
    bytes an element, over d ids of k indices each: row tiles of
    4 / itemsize rows, and per tile as many id ranges as one wave of
    ``n_sm`` blocks (one a SM: the tile takes ~121 KB) allows, none
    smaller than ``min_ids`` ids (``kernels/sweep_decode.py`` sweeps it).
    (k does not change the layout.)"""
    if itemsize not in (1, 2, 4) or not (1 <= m <= MAX_M) or B < 1 \
            or d < 1 or k < 1:
        raise ValueError(f"no plan for B={B} m={m} d={d} k={k} "
                         f"itemsize={itemsize}")
    rows = 4 // itemsize
    tiles = -(-B // rows)
    groups = max(1, min(n_sm // tiles, -(-d // min_ids)))
    chunk = IDS_PER_THREAD * -(-d // (groups * IDS_PER_THREAD))
    groups = -(-d // chunk)
    return Plan(rows, tiles, groups, chunk, tiles * groups, m * 4)


def variant_name(dtype: torch.dtype) -> str:
    """Launch-count name of the forward on logp stored as ``dtype``."""
    if dtype == torch.float32:
        return NAME
    return f"{NAME}.{quant.storage_name(dtype)}"


def min_bytes(B: int, m: int, d: int, k: int, logp_itemsize: int = 4,
              row_scales: bool = False, index_bytes: int = 4) -> int:
    """The least device-memory traffic of one forward: H once at
    ``index_bytes`` an index (2 for the packed copy the forward kernel
    reads, see ``pack_h``), each logp row once (and its f32 scale for
    int8), the (B, d) f32 scores once. The dense backward moves the same
    bytes at ``logp_itemsize=4`` and ``index_bytes=4``: the (B, d)
    cotangent and the int32 H in, the (B, m) f32 gradient out."""
    return int(d * k * index_bytes
               + B * (m * logp_itemsize + (4 if row_scales else 0))
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


def pack_h(H: torch.Tensor) -> torch.Tensor:
    """H (d, k) int32 in [0, m) as the kernel reads it: each index as a
    16-bit word (int16 holding the uint16 value; m <= MAX_M < 2**16)."""
    return torch.where(H >= 2 ** 15, H - 2 ** 16, H).to(torch.int16)


def bloom_decode_cuda(logp: torch.Tensor, H: torch.Tensor,
                      scales: Optional[torch.Tensor] = None,
                      packed: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream (no sync).

    logp (B, m) float32, bfloat16, int8 (with (B,) f32 ``scales``) or
    float8_e4m3fn; H (d, k) int32 in [0, m); contiguous, on one CUDA
    device.  The kernel reads H as ``pack_h(H)``: pass it as ``packed``
    (the spec's cached one, ``core.bloom.cached_packed_hash_matrix``), or
    it is packed here (one more launch).  Raises on anything the kernel
    does not take, and when a logp row does not fit in shared memory
    (m > MAX_M)."""
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
                         f"tile ({MAX_M} words)")
    if d * k >= 2 ** 31:
        raise ValueError(f"need d*k < 2**31, got d*k={d * k}")
    if B * d >= 2 ** 31:
        raise ValueError(f"need B*d < 2**31, got B={B} d={d}")
    if packed is not None and (packed.dtype != torch.int16
                               or packed.shape != H.shape
                               or packed.device != H.device
                               or not packed.is_contiguous()):
        raise ValueError("packed must be pack_h(H)")
    out = torch.empty((B, d), dtype=torch.float32, device=logp.device)
    if B and d:
        lib = _library()
        pl = _plan_for(logp.device, B, m, d, k, logp.element_size())
        H16 = pack_h(H) if packed is None else packed
        err = lib.bloom_decode_fwd(
            logp.data_ptr(), _CODES[logp.dtype],
            None if scales is None else scales.data_ptr(), H16.data_ptr(),
            out.data_ptr(), B, m, d, k, pl.tiles, pl.chunk, pl.grid,
            torch.cuda.current_stream(logp.device).cuda_stream)
        _raise_on(lib, err)
        common.count_launch(variant_name(logp.dtype))
    return out


def bloom_decode_fwd(logp: torch.Tensor, H: torch.Tensor,
                     scales: Optional[torch.Tensor] = None,
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel for CUDA tensors (reading ``packed``, or H packed
    per call), the plain version for CPU tensors."""
    if common.resolve_impl(logp, H, scales) == "kernel":
        return bloom_decode_cuda(logp, H, scales, packed)
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
    def forward(ctx, logp, H, bwd_impl, table_dtype, bins_fn, packed):
        if table_dtype is None:
            x, scales = (logp if logp.dtype in (torch.float32,
                                                torch.bfloat16)
                         else logp.float()), None
        else:
            x, scales = quant.quantize_table(logp, table_dtype)
        ctx.save_for_backward(H)
        ctx.m, ctx.dtype = logp.shape[1], logp.dtype
        ctx.bwd_impl, ctx.bins_fn = bwd_impl, bins_fn
        return bloom_decode_fwd(x.contiguous(), H, scales, packed)

    @staticmethod
    def backward(ctx, g):
        H, = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.bwd_impl == "csr":
            bins = ctx.bins_fn() if ctx.bins_fn is not None else None
            dlogp = bloom_csr.bloom_decode_bwd_csr(g, H, ctx.m, bins)
        else:
            dlogp = bloom_decode_bwd(g, H, ctx.m)
        return dlogp.to(ctx.dtype), None, None, None, None, None


def bloom_decode(logp: torch.Tensor, H: torch.Tensor, bwd_impl: str = "csr",
                 table_dtype: Optional[str] = None,
                 bins_fn: Optional[Callable] = None,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logp (B, m) float; H (d, k) int32 -> scores (B, d) float32: the
    kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in ``logp``.

    ``bwd_impl`` picks the backward: "csr" (the CSR scatter-add on the
    transposed cotangent; ``bins_fn``, a zero-argument callable returning
    ``bloom_csr.bin_csr(H, m)``, is called only in the backward, else H is
    binned there) or "dense" (H binned on the card per call, then the
    same scatter-add).  ``table_dtype``
    (core/quant.py) quantizes logp per call for the kernel to read narrow;
    its gradient is straight-through.  ``packed`` is ``pack_h(H)``, which
    the kernel reads (packed per call when None)."""
    common.resolve_bwd_impl(bwd_impl)
    return _BloomDecode.apply(logp, H, bwd_impl,
                              quant.resolve_table_dtype(table_dtype),
                              bins_fn, packed)


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.bloom_decode_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def _plan_for(device: torch.device, B: int, m: int, d: int, k: int,
              itemsize: int) -> Plan:
    return plan(B, m, d, k, itemsize, common.sm_count(device))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = common.load_library(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bloom_decode_fwd.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, p]
    lib.bloom_decode_fwd.restype = i
    lib.bloom_decode_error_string.argtypes = [i]
    lib.bloom_decode_error_string.restype = ctypes.c_char_p
    return lib
