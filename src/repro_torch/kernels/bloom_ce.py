"""Bloom softmax cross-entropy: the paper's training loss in the hashed
m-space, forward and backward.

For logits z (T, m) float32 and hashed labels h (T, k) int32 in [0, m):

    forward:   loss[t] = lse(z[t]) - (1/k) * sum_j z[t, h[t, j]],  and lse[t]
    backward:  dz[t] = g[t] * (exp(z[t] - lse[t]) - count_j(h[t]) / k)

where a label hashed twice to one column counts twice.  The forward keeps
``lse`` as the backward's residual, so each direction reads the (T, m) row
once.

Functions, each pair with one signature:

* ``bloom_ce_cuda`` / ``bloom_ce_bwd_cuda`` launch the hand-written Hopper
  kernels (``csrc/bloom_ce.cu``, which replace the JAX package's Pallas
  ``bloom_ce_pallas`` and ``bloom_ce_bwd_pallas``) on CUDA tensors, and
  count their launches (``bloom_ce_fwd``, ``bloom_ce_bwd``).
* ``bloom_ce_plain`` / ``bloom_ce_bwd_plain`` are the same functions in
  plain PyTorch on any device: the CPU path, and what the kernels are held
  against on the card.
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


def bloom_ce_bwd_plain(g: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                       lse: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch backward: dz (T, m) f32."""
    _check(z, h)
    counts = torch.zeros_like(z, dtype=torch.float32)
    counts.scatter_add_(1, h.long(), torch.ones(h.shape, device=z.device))
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
    if T >= 2 ** 31 or m >= 2 ** 28:      # the grid's x and y limits
        raise ValueError(f"need T < 2**31 and m < 2**28, got T={T} m={m}")


def bloom_ce_cuda(z: torch.Tensor, h: torch.Tensor):
    """Launch the forward kernel on PyTorch's current stream (no sync):
    (loss (T,), lse (T,)) f32.  z (T, m) float32 and h (T, k) int32,
    contiguous, on one CUDA device.  Label values are not checked (that
    would cost a device sync): callers pass ``BloomSpec.indices_for``
    output, which is in [0, m) by construction."""
    _check(z, h)
    _check_cuda(z, h)
    (T, m), k = z.shape, h.shape[1]
    loss = torch.empty(T, dtype=torch.float32, device=z.device)
    lse = torch.empty_like(loss)
    if T == 0:
        return loss, lse
    lib = _library()
    err = lib.bloom_ce_fwd(z.data_ptr(), h.data_ptr(), loss.data_ptr(),
                           lse.data_ptr(), T, m, k, _stream(z))
    _raise_on(lib, err, FWD)
    common.count_launch(FWD)
    return loss, lse


def bloom_ce_bwd_cuda(g: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                      lse: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on PyTorch's current stream (no sync):
    dz (T, m) f32 from the cotangent g (T,) and the forward's lse (T,)."""
    _check(z, h)
    _check_cuda(z, h, g, lse)
    (T, m), k = z.shape, h.shape[1]
    dz = torch.empty((T, m), dtype=torch.float32, device=z.device)
    if T == 0 or m == 0:
        return dz
    lib = _library()
    err = lib.bloom_ce_bwd(g.data_ptr(), z.data_ptr(), h.data_ptr(),
                           lse.data_ptr(), dz.data_ptr(), T, m, k,
                           _stream(z))
    _raise_on(lib, err, BWD)
    common.count_launch(BWD)
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = common.load_library(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bloom_ce_fwd.argtypes = [p, p, p, p, i, i, i, p]
    lib.bloom_ce_bwd.argtypes = [p, p, p, p, p, i, i, i, p]
    for fn in (lib.bloom_ce_fwd, lib.bloom_ce_bwd):
        fn.restype = i
    lib.bloom_ce_error_string.argtypes = [i]
    lib.bloom_ce_error_string.restype = ctypes.c_char_p
    return lib
