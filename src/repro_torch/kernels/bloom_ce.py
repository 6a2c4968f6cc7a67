"""Bloom softmax cross-entropy: the paper's training loss in the hashed
m-space, forward and backward.

For logits z (T, m) float32 and hashed labels h (T, k) int32 in [0, m):

    forward:   loss[t] = lse(z[t]) - (1/k) * sum_j z[t, h[t, j]],  and lse[t]
    backward:  dz[t] = g[t] * (exp(z[t] - lse[t]) - count_j(h[t]) / k)

where a label hashed twice to one column counts twice.  The forward keeps
``lse`` as the backward's residual, so each direction reads the (T, m) row
once.

A row range serves the vocab-parallel loss of a tensor-parallel step: z
is then the columns [lo, lo + m) of the full logits (one rank's shard) and
h the global labels.  The ranged forward returns the shard's local lse and
its local hit sum (the picked logits of the labels that fall in the shard,
added in j order); the caller combines the ranks' values into the global
lse and hit sum, and the ranged backward takes that global lse, so its dz
is exact on the shard.  ``lo = 0`` over the whole row is the unranged
function, bit for bit.

Functions, each pair with one signature:

* ``bloom_ce_cuda`` / ``bloom_ce_bwd_cuda`` launch the hand-written Hopper
  kernels (``csrc/bloom_ce.cu``, which replace the JAX package's Pallas
  ``bloom_ce_pallas`` and ``bloom_ce_bwd_pallas``) on CUDA tensors, and
  count their launches (``bloom_ce_fwd``, ``bloom_ce_bwd``).
* ``bloom_ce_plain`` / ``bloom_ce_bwd_plain`` are the same functions in
  plain PyTorch on any device: the CPU path, and what the kernels are held
  against on the card.
* ``bloom_ce_shard_cuda`` / ``bloom_ce_shard_plain`` are the ranged
  forward (local lse and hit sum), the kernel counted as
  ``bloom_ce_fwd.range``; ``bloom_ce_bwd_cuda`` / ``bloom_ce_bwd_plain``
  take the range as ``lo`` (the kernel counted as ``bloom_ce_bwd.range``
  when ``lo`` is given).  ``kernels.ops.bloom_ce_sharded`` is the
  differentiable vocab-parallel loss over them.
* ``launch_fwd`` / ``launch_bwd`` are one uncounted launch of a given
  library's kernel (this tree's or another commit's), for the sweep
  (``sweep_ce``) and the parent comparison in ``chip_smoke.py``.
* ``bloom_ce`` is the differentiable entry: an ``autograd.Function`` that
  takes the kernels for CUDA tensors and the plain versions for CPU
  tensors (``common.resolve_impl``), saves ``(z, h, lse)`` and returns
  ``dz`` in ``z``'s dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common

NAME = "bloom_ce"
FWD, BWD = "bloom_ce_fwd", "bloom_ce_bwd"
FWD_RANGE, BWD_RANGE = f"{FWD}.range", f"{BWD}.range"


def min_bytes(T: int, m: int, k: int, backward: bool = False) -> int:
    """The least device-memory traffic of one call: the (T, m) f32 logits
    and the (T, k) int32 labels once; forward writes loss and lse (T,) f32,
    backward reads g and lse (T,) and writes dz (T, m) f32."""
    if backward:
        return int(2 * T * m * 4 + T * k * 4 + 2 * T * 4)
    return int(T * m * 4 + T * k * 4 + 2 * T * 4)


def _check(z: torch.Tensor, h: torch.Tensor) -> None:
    if z.ndim != 2 or h.ndim != 2 or h.shape[0] != z.shape[0]:
        raise ValueError(f"need z (T, m) and h (T, k), got "
                         f"{tuple(z.shape)} and {tuple(h.shape)}")
    if h.shape[1] < 1:
        raise ValueError("need k >= 1 hashed labels per row")


def bloom_ce_plain(z: torch.Tensor, h: torch.Tensor):
    """The plain PyTorch forward: (loss (T,), lse (T,)) in f32, the picked
    logits added in j order and divided by k, as the kernel does."""
    _check(z, h)
    z = z.float()
    zmax = z.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(z - zmax).sum(dim=-1)) + zmax[:, 0]
    picked = z.gather(1, h.long())
    s = picked[:, 0]
    for j in range(1, h.shape[1]):
        s = s + picked[:, j]
    return lse - s / h.shape[1], lse


def _in_shard(h: torch.Tensor, lo: int, m: int):
    """(column in the shard clamped into it, whether it lies there)."""
    rel = h.long() - lo
    inside = (rel >= 0) & (rel < m)
    return rel.clamp(0, max(m - 1, 0)), inside


def bloom_ce_shard_plain(z: torch.Tensor, h: torch.Tensor, lo: int):
    """The ranged forward in plain PyTorch: z (T, m) the columns [lo,
    lo + m) of the logits, h (T, k) the global labels -> (lse (T,), hits
    (T,)) f32, the shard's local lse and the sum of its picked logits (the
    labels in the shard, added in j order from 0.0, as the kernel adds
    them)."""
    _check(z, h)
    z = z.float()
    zmax = z.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(z - zmax).sum(dim=-1)) + zmax[:, 0]
    col, inside = _in_shard(h, lo, z.shape[1])
    picked = torch.where(inside, z.gather(1, col), 0.0)
    s = torch.zeros_like(lse)
    for j in range(h.shape[1]):
        s = s + picked[:, j]
    return lse, s


def bloom_ce_bwd_plain(g: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                       lse: torch.Tensor, lo: int | None = None
                       ) -> torch.Tensor:
    """The plain PyTorch backward: dz (T, m) f32.  With ``lo`` z is the
    columns [lo, lo + m) and h the global labels; only the labels in the
    shard count, and ``lse`` is the global one."""
    _check(z, h)
    col, inside = _in_shard(h, lo or 0, z.shape[1])
    counts = torch.zeros_like(z, dtype=torch.float32)
    counts.scatter_add_(1, col, inside.float())
    p = torch.exp(z.float() - lse[:, None])
    return g[:, None] * (p - counts / h.shape[1])


def _check_cuda(z, h, *vectors) -> None:
    tensors = (z, h, *vectors)
    dev = z.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("all tensors must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in (z, *vectors)) \
            or h.dtype != torch.int32:
        raise TypeError(f"need float32 z, g and lse and int32 h, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("z, h, g and lse must be contiguous")
    T, m = z.shape
    if any(v.shape != (T,) for v in vectors):
        raise ValueError(f"need g and lse of shape ({T},)")
    if T >= 2 ** 31 or m >= 2 ** 28:      # the kernels' int indices
        raise ValueError(f"need T < 2**31 and m < 2**28, got T={T} m={m}")


def launch_fwd(lib, z: torch.Tensor, h: torch.Tensor, lo: int | None = None):
    """One launch of ``lib``'s forward kernel, uncounted and unchecked:
    (loss, lse) without ``lo``, (lse, hits) with it.  The wrappers below
    call it with this tree's library; ``sweep_ce`` and ``chip_smoke.py``
    also with another commit's."""
    (T, m), k = z.shape, h.shape[1]
    lse = torch.empty(T, dtype=torch.float32, device=z.device)
    other = torch.empty_like(lse)
    if T:
        err = lib.bloom_ce_fwd(
            z.data_ptr(), h.data_ptr(), None if lo is not None else
            other.data_ptr(), lse.data_ptr(), None if lo is None else
            other.data_ptr(), T, m, k, lo or 0, _stream(z))
        _raise_on(lib, err, FWD if lo is None else FWD_RANGE)
    return (other, lse) if lo is None else (lse, other)


def launch_bwd(lib, g: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
               lse: torch.Tensor, lo: int | None = None) -> torch.Tensor:
    """One launch of ``lib``'s backward kernel (``launch_fwd``'s kin)."""
    (T, m), k = z.shape, h.shape[1]
    dz = torch.empty((T, m), dtype=torch.float32, device=z.device)
    if T and m:
        err = lib.bloom_ce_bwd(g.data_ptr(), z.data_ptr(), h.data_ptr(),
                               lse.data_ptr(), dz.data_ptr(), T, m, k,
                               lo or 0, _stream(z))
        _raise_on(lib, err, BWD if lo is None else BWD_RANGE)
    return dz


def bloom_ce_cuda(z: torch.Tensor, h: torch.Tensor):
    """Launch the forward kernel on PyTorch's current stream (no sync):
    (loss (T,), lse (T,)) f32.  z (T, m) float32 and h (T, k) int32,
    contiguous, on one CUDA device.  Label values are not checked (that
    would cost a device sync): callers pass ``BloomSpec.indices_for``
    output, which is in [0, m) by construction."""
    _check(z, h)
    _check_cuda(z, h)
    if z.shape[0] == 0:
        return launch_fwd(None, z, h)
    out = launch_fwd(_library(), z, h)
    common.count_launch(FWD)
    return out


def _check_lo(lo: int) -> None:
    if not 0 <= lo < 2 ** 31:
        raise ValueError(f"need 0 <= lo < 2**31, got {lo}")


def bloom_ce_shard_cuda(z: torch.Tensor, h: torch.Tensor, lo: int):
    """Launch the ranged forward kernel on PyTorch's current stream (no
    sync), counted as ``bloom_ce_fwd.range``: z (T, m) float32 the columns
    [lo, lo + m) of the logits, h (T, k) int32 global labels ->
    (lse (T,), hits (T,)) f32 (``bloom_ce_shard_plain``)."""
    _check(z, h)
    _check_cuda(z, h)
    _check_lo(lo)
    if z.shape[0] == 0:
        return launch_fwd(None, z, h, lo)
    out = launch_fwd(_library(), z, h, lo)
    common.count_launch(FWD_RANGE)
    return out


def bloom_ce_bwd_cuda(g: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                      lse: torch.Tensor, lo: int | None = None
                      ) -> torch.Tensor:
    """Launch the backward kernel on PyTorch's current stream (no sync):
    dz (T, m) f32 from the cotangent g (T,) and the forward's lse (T,).
    With ``lo`` (counted as ``bloom_ce_bwd.range``) z is the columns
    [lo, lo + m), h the global labels and ``lse`` the global one."""
    _check(z, h)
    _check_cuda(z, h, g, lse)
    if lo is not None:
        _check_lo(lo)
    if z.numel() == 0:
        return launch_bwd(None, g, z, h, lse, lo)
    dz = launch_bwd(_library(), g, z, h, lse, lo)
    common.count_launch(BWD if lo is None else BWD_RANGE)
    return dz


class _BloomCE(torch.autograd.Function):
    """loss (T,) f32 of z (T, m); the backward returns dz in z's dtype."""

    @staticmethod
    def forward(ctx, z, h):
        if common.resolve_impl(z, h) == "kernel":
            loss, lse = bloom_ce_cuda(z, h)
        else:
            loss, lse = bloom_ce_plain(z, h)
        ctx.save_for_backward(z, h, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        z, h, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if common.resolve_impl(z, h) == "kernel":
            dz = bloom_ce_bwd_cuda(g, z, h, lse)
        else:
            dz = bloom_ce_bwd_plain(g, z, h, lse)
        return dz.to(z.dtype), None


def bloom_ce(z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Per-row Bloom CE loss (T,) f32, differentiable in ``z``: the kernels
    for CUDA tensors, the plain versions for CPU tensors."""
    return _BloomCE.apply(z, h)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.bloom_ce_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded ``csrc/bloom_ce.cu`` library
    (this tree's, or another commit's with the same interface); returns
    ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bloom_ce_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.bloom_ce_bwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    for fn in (lib.bloom_ce_fwd, lib.bloom_ce_bwd):
        fn.restype = i
    lib.bloom_ce_error_string.argtypes = [i]
    lib.bloom_ce_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(common.load_library(NAME))
