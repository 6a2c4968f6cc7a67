"""Fused Bloom vocabulary recovery + top-k: the serving decode (Eq. 3).

For each row b of ``logp`` (B, m): the top ``topk`` item ids over [0, d)
of ``score[b, i] = sum_j row_b[h_j(i)]`` (summed in f32 in j order),
ranked by (score descending, id ascending), so equal scores resolve to the
lowest id.  ``row_b`` is logp row b as f32: logp may be stored narrow
(``table_dtype``, core/quant.py) as bf16, fp8 e4m3, or int8 with a (B,)
f32 per-row ``scales`` multiplied in before the gather.  The indices h_j(i)
are H[i, j] of a (d, k) hash matrix, or, with ``H=None`` and
``hash_spec=(d, k, seed)``, re-derived per id by the enhanced double hash
of ``core.hashing.double_hash`` (bit-identical to the cached matrix of an
on-the-fly spec).  Rows with ``active[b] == 0`` return (-inf, 0).  The
(B, d) score matrix is never materialised.

Three functions with one signature
``(logp, H, topk, active=None, scales=None, hash_spec=None)``:

* ``bloom_decode_topk_cuda`` launches the hand-written Hopper kernel
  (``csrc/bloom_decode_topk.cu``, which replaces the JAX package's Pallas
  ``bloom_decode_topk_pallas`` and its ``has_scales`` / ``hash_spec``
  variants) on CUDA tensors, and counts its launches: ``bloom_decode_topk``
  for f32 logp with H, ``bloom_decode_topk.<dtype>[.hash]`` for the
  others (``variant_name``).
* ``bloom_decode_topk_plain`` is the same function in plain PyTorch on any
  device: Eq. 3 scores one vocab chunk at a time, merged into the running
  best with a stable descending sort.  The CPU path, and what the kernel is
  held against on the card.
* ``bloom_decode_topk`` picks between them by the tensors' device
  (kernels.common.resolve_impl): CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing, quant
from repro_torch.kernels import common
from repro_torch.kernels.common import (  # noqa: F401
    hash_constants, magic_divisor)

NAME = "bloom_decode_topk"
PLAIN_CHUNK = 65536
# the kernel stages a tile's logp rows in shared memory, so one f32 row
# (RP = 1) must fit a block's 227 KB beside its warp lists
MAX_M = 56 * 1024
# shared memory one block may take on sm_90a (H100, H200), and an upper
# bound on the kernel's static shared arrays
SMEM_LIMIT = 232_448
SMEM_STATIC = 1024
# the kernel's caps: rows per tile, warps per block
MAX_ROWS, MAX_WARPS = 8, 16
# the plan's rows per tile: at most PLAN_ROWS, and no more than a block's
# share of the catalog repays: a tile's staged bytes (m * itemsize * rows)
# stay within STAGE_BYTES_PER_ID bytes per id-row a block scores
# (d * B / blocks).  Measured on the H100 by sweep_decode_topk: at web10m
# 4 rows beat 8 (int8 with the hash, 0.144893 against 0.148827 ms with 8
# rows live, 0.088104 against 0.107087 with 3); at the LM shapes one row
# beat 2 with 3 of 8 rows live (0.015861 against 0.018531 ms) and lost
# with all 8 (0.022902 against 0.020365), a pool being often part full.
# One-byte rows staged as f32 (the same rule on 4 bytes a value) spare the
# gathers their widening (a byte permute, a subtraction, for int8 the scale
# multiply): at web10m with the in-kernel hash int8 took 0.134434 against
# 0.144424 ms, where bf16 (a shift to widen) took 0.132959 against
# 0.132402; with the explicit H, bound by the shared-memory reads, int8
# took 0.114661 against 0.110013 (one sweep). So the wrapper widens one-byte
# rows under the hash only
PLAN_ROWS = 4
STAGE_BYTES_PER_ID = 4
# the logp storage dtype codes of csrc/bloom_decode_topk.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}
# integer operations of the in-kernel hash per id, as the reference's
# formula states them: two salted splitmix32 (an xor and 9 operations
# each), h1's modulo, h2's modulo and add, then for each j >= 1 a
# multiply, two adds and a modulo
HASH_OPS_BASE, HASH_OPS_PER_J = 23, 4


def hash_ops(d: int, k: int) -> int:
    """Integer operations of the in-kernel hash of d ids, once per id."""
    return int(d * (HASH_OPS_BASE + HASH_OPS_PER_J * (k - 1)))


class Plan(NamedTuple):
    """How one call lays out on the card: ``rows`` live rows per tile (the
    kernel's RP), ``warps`` per block, ``grid`` blocks (one per SM),
    ``rows_bytes`` of shared memory for the staged rows (which the last
    block of a tile reuses to merge), ``cw`` entries per warp list,
    ``smem`` the dynamic shared memory of a block, and ``widen``: narrow
    logp staged as f32 (widened once, not at every gather)."""
    rows: int
    warps: int
    grid: int
    rows_bytes: int
    cw: int
    smem: int
    widen: bool


def plan(B: int, m: int, itemsize: int, topk: int, n_sm: int,
         d: int | None = None, max_rows: int = PLAN_ROWS,
         warps: int | None = None, grid: int | None = None,
         widen: bool | None = None) -> Plan:
    """The launch plan of a call on logp (B, m) stored ``itemsize`` bytes
    an element, over d ids: the most rows per tile, a power of two up to
    min(``max_rows``, B rounded up) whose staging the catalog repays (see
    ``STAGE_BYTES_PER_ID``; no such cap without ``d``), whose staged rows
    ([m][rows] at the stored width) fit with at least 8 warps' lists (a
    single row with as many as fit), then the most warps up to 16 (or
    ``warps``); ``grid`` defaults to one block per SM.  Narrow logp is
    staged as f32 where the same rows fit so, if ``widen``, or by default
    for one-byte storage when the catalog repays those bytes too.  Every
    plan fits ``SMEM_LIMIT`` with ``SMEM_STATIC`` to spare."""
    cw = 32 * -(-(topk + 32) // 32)
    grid = n_sm if grid is None else grid
    share = None if d is None else STAGE_BYTES_PER_ID * d * B / grid
    top = 1
    while top < min(max_rows, B, MAX_ROWS):
        top *= 2
    while share is not None and top > 1 and m * itemsize * top > share:
        top //= 2
    rp = top
    while True:
        fit = _fit(m * itemsize, rp, topk, cw, grid, warps)
        if fit is not None:
            break
        if rp == 1:
            raise ValueError(f"m={m} leaves no room for one warp's lists")
        rp //= 2
    wide = itemsize < 4 and (widen if widen is not None else
                             itemsize == 1 and share is not None
                             and m * 4 * rp <= share)
    if wide:
        wide_fit = _fit(m * 4, rp, topk, cw, grid, warps)
        wide = wide_fit is not None
        fit = wide_fit if wide else fit
    rows_bytes, nw = fit
    return Plan(rp, nw, grid, rows_bytes, cw,
                rows_bytes + nw * rp * (cw * 8 + 4), wide)


def _fit(row_bytes: int, rp: int, topk: int, cw: int, grid: int,
         warps: int | None):
    """(rows_bytes, warps) of ``rp`` staged rows of ``row_bytes`` each with
    the most warps' lists that fit, or None below 8 warps (below 1 for a
    single row)."""
    rows_bytes = max(_align16(row_bytes * rp),
                     _align16(rp * grid * 12 + rp * 2 * topk * 8))
    room = SMEM_LIMIT - SMEM_STATIC - rows_bytes
    want = MAX_WARPS if warps is None else warps
    nw = min(want, max(0, room // (rp * (cw * 8 + 4))))
    if nw >= min(8, want) or (rp == 1 and nw >= 1):
        return rows_bytes, nw
    return None


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def variant_name(dtype: torch.dtype, hashed: bool) -> str:
    """Launch-count name of a call on logp stored as ``dtype``, with
    (``hashed``) or without the in-kernel hash."""
    if dtype == torch.float32 and not hashed:
        return NAME
    return f"{NAME}.{quant.storage_name(dtype)}" + (".hash" if hashed else "")


def modeled_hbm_bytes(active, b_tile: int, *, m: int, d: int, k: int,
                      topk: int, logp_itemsize: int = 4,
                      inkernel_hash: bool = False,
                      row_scales: bool = False) -> int:
    """HBM bytes of one decode-topk call as the JAX package's TPU grid
    streams them (its row-block grid re-streams H per visited block of
    ``b_tile`` rows).  Kept as the reference computes it so the port's
    serving drill reports the same integers; it models the TPU grid, not
    this port's kernel (see ``min_bytes`` for that).

    Per VISITED row block the grid streams the (b_tile, m) logp block at
    ``logp_itemsize`` bytes/element plus one full (d, k) i32 sweep of H —
    unless ``inkernel_hash``, where the hash indices are re-derived at zero
    HBM cost.  ``row_scales`` adds the (b_tile,) f32 int8 dequant scales per
    visited block.  Blocks with no live slot fetch nothing.  The (B, topk)
    f32+i32 outputs are flushed for every block, live or dead.  A dense (no
    ``active``) grid is the all-ones mask.
    """
    act = np.asarray(active, bool).ravel()
    B = act.shape[0]
    pad = (-B) % b_tile
    if pad:
        act = np.concatenate([act, np.zeros(pad, bool)])
    n_visited = int(act.reshape(-1, b_tile).any(axis=1).sum())
    per_block = b_tile * m * logp_itemsize
    if not inkernel_hash:
        per_block += d * k * 4
    if row_scales:
        per_block += b_tile * 4
    return int(n_visited * per_block + B * topk * 8)


def min_bytes(n_live: int, B: int, *, m: int, d: int, k: int,
              topk: int, logp_itemsize: int = 4,
              inkernel_hash: bool = False, row_scales: bool = False) -> int:
    """The least device-memory traffic of one call: H read once (none with
    the in-kernel hash), each live logp row once at ``logp_itemsize`` bytes
    an element (and its f32 scale for int8), the (B, topk) f32 + i32
    outputs written once."""
    return int((0 if inkernel_hash else d * k * 4)
               + n_live * (m * logp_itemsize + (4 if row_scales else 0))
               + B * topk * 8)


def _check_shapes(logp: torch.Tensor, H, topk: int, active, scales=None,
                  hash_spec=None):
    """Shapes and the (H, hash_spec), (dtype, scales) pairings; returns
    (d, k)."""
    if logp.ndim != 2:
        raise ValueError(f"need logp (B, m), got {tuple(logp.shape)}")
    B, m = logp.shape
    if (H is None) == (hash_spec is None):
        raise ValueError("pass exactly one of H and hash_spec")
    if H is not None:
        if H.ndim != 2:
            raise ValueError(f"need H (d, k), got {tuple(H.shape)}")
        d, k = H.shape
    else:
        d, k, _ = hash_spec
        if not 1 <= k <= m:
            raise ValueError(f"need 1 <= k <= m, got k={k} m={m}")
    if not (0 < topk <= d):
        raise ValueError(f"need 0 < topk <= d, got topk={topk} d={d}")
    if active is not None and tuple(active.shape) != (B,):
        raise ValueError(f"active must be ({B},), got "
                         f"{tuple(active.shape)}")
    if logp.dtype not in _CODES:
        raise TypeError(f"logp must be stored as one of {tuple(_CODES)}, "
                        f"got {logp.dtype}")
    if (scales is not None) != (logp.dtype == torch.int8):
        raise ValueError("int8 logp needs its (B,) row scales, and only "
                         "int8 logp takes scales")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (B,)):
        raise ValueError(f"scales must be ({B},) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    return d, k


def bloom_decode_topk_plain(logp: torch.Tensor, H: torch.Tensor | None,
                            topk: int, active: torch.Tensor | None = None,
                            scales: torch.Tensor | None = None,
                            hash_spec: tuple | None = None):
    """The plain PyTorch version: values (B, topk) f32 descending and ids
    (B, topk) int32, on logp's device.

    The first chunk seeds the running best (no sentinels, so a row of -inf
    scores still returns real ids); each later chunk is concatenated AFTER
    the running best, whose ids are all lower, and a stable descending sort
    keeps equal scores in ascending id order.  Without H each chunk's
    indices come from ``hashing.double_hash``."""
    d, k = _check_shapes(logp, H, topk, active, scales, hash_spec)
    B, m = logp.shape
    dev = logp.device
    vals = torch.full((B, topk), -math.inf, dtype=torch.float32, device=dev)
    ids = torch.zeros((B, topk), dtype=torch.int32, device=dev)
    rows = (torch.arange(B, device=dev) if active is None
            else torch.nonzero(active.to(torch.bool)).flatten())
    if rows.numel() == 0:
        return vals, ids
    lp = logp[rows].float()
    if scales is not None:
        lp = lp * scales[rows][:, None]
    best_v = best_i = None
    for c0 in range(0, d, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, d)
        if H is not None:
            h = H[c0:c1].long()
        else:
            cid64 = torch.arange(c0, c1, dtype=torch.int64, device=dev)
            h = hashing.double_hash(cid64, k, m, hash_spec[2]).long()
        s = lp[:, h[:, 0]]
        for j in range(1, k):
            s = s + lp[:, h[:, j]]
        cid = torch.arange(c0, c1, dtype=torch.int32,
                           device=dev).expand(s.shape)
        if best_v is not None:
            s = torch.cat([best_v, s], dim=1)
            cid = torch.cat([best_i, cid], dim=1)
        s, order = torch.sort(s, dim=1, descending=True, stable=True)
        best_v = s[:, :topk]
        best_i = torch.gather(cid, 1, order[:, :topk])
    vals[rows] = best_v
    ids[rows] = best_i
    return vals, ids


def bloom_decode_topk_cuda(logp: torch.Tensor, H: torch.Tensor | None,
                           topk: int, active: torch.Tensor | None = None,
                           scales: torch.Tensor | None = None,
                           hash_spec: tuple | None = None):
    """Launch the Hopper kernel on PyTorch's current stream (no sync).

    logp (B, m) float32, bfloat16, int8 (with (B,) f32 ``scales``) or
    float8_e4m3fn; H (d, k) int32, or None with ``hash_spec=(d, k, seed)``
    to hash in the kernel; contiguous, on one CUDA device; ``active`` (B,)
    bool or int, or None.  Raises on anything the kernel does not take."""
    d, k = _check_shapes(logp, H, topk, active, scales, hash_spec)
    tensors = [t for t in (logp, H, scales) if t is not None]
    if not all(t.is_cuda and t.device == logp.device for t in tensors):
        raise ValueError("logp, H and scales must lie on one CUDA device")
    if H is not None and H.dtype != torch.int32:
        raise TypeError(f"need int32 H, got {H.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("logp, H and scales must be contiguous")
    B, m = logp.shape
    if H is not None and k == 2 and H.data_ptr() % 8:
        raise ValueError("k = 2 needs H on an 8-byte boundary (the kernel "
                         "loads each row as one int2)")
    if d >= 2 ** 31 or B >= 2 ** 31:
        raise ValueError(f"need d, B < 2**31, got d={d} B={B}")
    if m > MAX_M:
        raise ValueError(f"m={m} exceeds the kernel's shared-memory row "
                         f"({MAX_M} floats)")
    lib = _library()
    if topk > lib.bloom_decode_topk_max_topk():
        raise ValueError(f"topk={topk} exceeds the kernel's maximum "
                         f"{lib.bloom_decode_topk_max_topk()}")
    if H is None and k > lib.bloom_decode_topk_max_hash_k():
        raise ValueError(f"k={k} exceeds the in-kernel hash's maximum "
                         f"{lib.bloom_decode_topk_max_hash_k()}")
    act = None
    if active is not None:
        if active.device != logp.device:
            raise ValueError("active must lie on logp's device")
        act = active.to(torch.int32).contiguous()
    vals, ids = _launch(lib, logp, H, topk, act, scales, hash_spec)
    common.count_launch(variant_name(logp.dtype, H is None))
    return vals, ids


def _launch(lib: ctypes.CDLL, logp: torch.Tensor, H: torch.Tensor | None,
            topk: int, act: torch.Tensor | None,
            scales: torch.Tensor | None = None,
            hash_spec: tuple | None = None, pl: Plan | None = None):
    """One launch into fresh outputs, on the current stream, with inputs
    the caller has checked; ``act`` is (B,) int32 or None; ``pl`` the plan
    (default: ``_plan_for``).  Raises on a CUDA error; counts nothing."""
    (B, m), dev = logp.shape, logp.device
    if H is not None:
        (d, k), seed = H.shape, 0
    else:
        d, k, seed = hash_spec
    if pl is None:
        # the kernel takes H with k > 4 one row a tile; one-byte rows are
        # widened while staging only under the in-kernel hash (see
        # PLAN_ROWS)
        pl = _plan_for(dev, B, m, logp.element_size(), topk, d,
                       1 if H is not None and k > 4 else PLAN_ROWS,
                       None if H is None else False)
    c1, c2, mp_m, sh_m, mp_m1, sh_m1 = hash_constants(m, seed)
    tickets, part = _scratch(dev, B, max(pl.grid, B) * pl.rows * topk)
    vals = torch.empty((B, topk), dtype=torch.float32, device=dev)
    ids = torch.empty((B, topk), dtype=torch.int32, device=dev)
    err = lib.bloom_decode_topk(
        logp.data_ptr(), _CODES[logp.dtype],
        None if scales is None else scales.data_ptr(),
        None if H is None else H.data_ptr(), c1, c2, mp_m, sh_m, mp_m1,
        sh_m1, None if act is None else act.data_ptr(), tickets.data_ptr(),
        part.data_ptr(), vals.data_ptr(), ids.data_ptr(), B, m, d, k, topk,
        pl.rows, pl.warps, pl.grid, pl.rows_bytes, pl.cw, int(pl.widen),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.bloom_decode_topk_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    return vals, ids


@functools.lru_cache(maxsize=None)
def _plan_for(device: torch.device, B: int, m: int, itemsize: int,
              topk: int, d: int, max_rows: int,
              widen: bool | None) -> Plan:
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(B, m, itemsize, topk, n_sm, d, max_rows, widen=widen)


# per device: (tickets, part), the kernel's scratch, kept across calls. The
# kernel leaves the tickets zero, so calls on one device must not overlap:
# every caller issues them on one stream.
_SCRATCH: dict = {}


def _scratch(device: torch.device, n_tickets: int, n_part: int):
    """The device's ticket counters (>= n_tickets int32, zero) and partial
    lists (>= n_part int64), grown when a call needs more.  Growing is
    refused while a CUDA graph is being captured: call once first."""
    key = torch.device(device).index
    tickets, part = _SCRATCH.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets or part.numel() < n_part:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{NAME}: its scratch must grow, which a "
                               "CUDA graph capture cannot do; call it once "
                               "at this shape before capturing")
        n_tickets = max(n_tickets, 0 if tickets is None else tickets.numel())
        n_part = max(n_part, 0 if part is None else part.numel())
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
        part = torch.empty(n_part, dtype=torch.int64, device=device)
        _SCRATCH[key] = (tickets, part)
    return tickets, part


def bloom_decode_topk(logp: torch.Tensor, H: torch.Tensor | None, topk: int,
                      active: torch.Tensor | None = None,
                      scales: torch.Tensor | None = None,
                      hash_spec: tuple | None = None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if common.resolve_impl(logp, H, active, scales) == "kernel":
        return bloom_decode_topk_cuda(logp, H, topk, active, scales,
                                      hash_spec)

    def least_bytes():
        (B, m), (d, k) = logp.shape, (H.shape if H is not None
                                      else hash_spec[:2])
        return min_bytes(B, B, m=m, d=d, k=k, topk=topk,
                         logp_itemsize=logp.element_size(),
                         inkernel_hash=H is None,
                         row_scales=scales is not None)

    return common.run_plain(
        lambda: variant_name(logp.dtype, H is None), least_bytes,
        bloom_decode_topk_plain, logp, H, topk, active, scales, hash_spec)


@functools.lru_cache(maxsize=None)
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The built kernel; ``defines`` (``-D`` flags) select a tuning
    variant, as ``sweep_decode_topk`` does."""
    lib = common.load_library(NAME, defines)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.bloom_decode_topk.argtypes = [p, i, p, p, u, u, u, u, u, u, p, p,
                                      p, p, p, i, i, i, i, i, i, i, i, i,
                                      i, i, p]
    lib.bloom_decode_topk.restype = i
    for fn in (lib.bloom_decode_topk_max_topk,
               lib.bloom_decode_topk_max_hash_k):
        fn.argtypes = []
        fn.restype = i
    lib.bloom_decode_topk_error_string.argtypes = [i]
    lib.bloom_decode_topk_error_string.restype = ctypes.c_char_p
    return lib
