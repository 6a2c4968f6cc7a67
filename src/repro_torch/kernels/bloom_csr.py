"""CSR scatter-add: the backward of the Bloom embedding.

For a cotangent g (T, D) and hash indices idx (T, k) in [0, m):

    out[r, :] = sum over (t, j) with idx[t, j] == r of g[t, :]     (m, D) f32

``bin_csr`` sorts the flat (T * k) indices stably by value, so each output
row owns one segment of entries in (token, j) order; ``row_ptr`` (m + 1)
marks the segments and ``src`` holds each entry's token row.  Values below
0 sort as -1 and values from m up as m, so out-of-range entries (the -1
pads) fall outside every segment, in entry order.  Every row is summed in
f32 from 0.0 in that order, so the result is the same from run to run: no
float atomics anywhere.

* ``bin_csr_cuda`` bins on the card in one short run of hand-written
  launches (``csrc/bloom_csr.cu`` ``bloom_csr_bin``, planned by
  ``bin_plan``: shared-memory integer atomics count and place the entries,
  scans give the row pointers, and each segment is put back into entry
  order by rank), counted as ``bloom_csr.bin``;
  ``bin_csr_plain`` is the same binning with ``torch.sort`` (stable) and
  ``searchsorted``, and the two give equal bins; ``bin_csr`` picks one by
  idx's device.
* A row range (``lo``: the backward of one rank's shard of a
  vocab-parallel embedding, the rows [lo, lo + m) of the table) bins
  v - lo instead of v, so the entries of other shards' rows fall outside
  every segment like the pads; the card's ranged binning is counted as
  ``bloom_csr.bin.range``.  The scatter is unchanged: it sums the shard's
  m rows.
* ``csr_scatter_add_cuda`` launches the hand-written Hopper kernel
  (``csrc/bloom_csr.cu``, which replaces the JAX package's Pallas
  ``csr_scatter_add_pallas``, reached through
  ``bloom_embed_bwd_csr_pallas``) on CUDA tensors, and counts its launches.
  A block owns a run of ``rows_per_block`` consecutive rows.
* ``csr_scatter_add_plain`` is the same function in plain PyTorch:
  ``zeros(m, D).index_add_`` over the same sorted entries.  On the CPU,
  where ``index_add_`` adds in index order, it is bit-identical to the
  kernel; on a CUDA tensor ``index_add_`` uses atomics, so the card's
  comparisons hold the kernel against a CPU copy.
* ``csr_scatter_add`` bins and picks one of them by the tensors' device
  (``common.resolve_impl``).
* ``bloom_decode_bwd_csr`` is the same scatter-add as the backward of the
  Eq. 3 decode (the reference's ``bloom_decode_bwd_csr_pallas``): on the
  transposed (d, B) cotangent with H's bins, usually the per-spec cached
  ones (``core.bloom.cached_decode_bins``), transposed back.  Its kernel
  launches are counted as ``bloom_csr.decode``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import common

NAME = "bloom_csr"
DECODE = f"{NAME}.decode"    # launches from the decode backward
BIN = f"{NAME}.bin"          # launches of the binning
BIN_RANGE = f"{BIN}.range"   # ... over a row range
DTYPES = (torch.float32, torch.bfloat16)
# the scatter kernel's block, the most rows a block owns, and the
# (row, chunk) pairs a block aims at (8 a thread)
THREADS = 256
MAX_ROWS = 2048
PAIRS_PER_BLOCK = 8 * THREADS
# the binning's plan (csrc/bloom_csr.cu mirrors it): the one-launch path's
# most entries; the two-level path's buckets a group, most groups (a block
# keeps a counter per group in shared memory), entries a round, and most
# chunks
SMALL_ENTRIES = 8192
GROUP = 64
MAX_GROUPS = 2048
SUB = 2048
MAX_CHUNKS = 1024
MAX_GROUPED_ENTRIES = 2 ** 25 - 1    # an entry is packed with its bucket


class CSRBins(NamedTuple):
    row_ptr: torch.Tensor   # (m + 1,) int32: row r's entries are
    #                         [row_ptr[r], row_ptr[r + 1])
    src: torch.Tensor       # (T * k,) int32 token row of each sorted entry


def bin_csr_plain(idx: torch.Tensor, m: int,
                  lo: int | None = None) -> CSRBins:
    """Bin idx (T, k) into m row segments with torch ops on idx's device
    (with ``lo``: the rows [lo, lo + m), entry v in row v - lo).  The row
    pointers come from a search over the sorted values, not from
    ``bincount``, which would cost a device sync on CUDA."""
    T, k = idx.shape
    keys = (idx.reshape(-1).long() - (lo or 0)).clamp(-1, m)
    keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(m + 1, device=idx.device)
    row_ptr = torch.searchsorted(keys, bounds).to(torch.int32)
    return CSRBins(row_ptr, (order // k).to(torch.int32))


def bin_plan(n_entries: int, m: int) -> tuple:
    """(chunk, int32 scratch) of one ``bloom_csr_bin`` call.  Up to
    SMALL_ENTRIES entries take the one-launch path: chunk 0, no scratch.
    More take the two-level path: chunks of a multiple of SUB entries, at
    most MAX_CHUNKS of them, and scratch for the entries split by group,
    the (groups, chunks) table of counts and the groups' totals."""
    if n_entries <= SMALL_ENTRIES:
        return 0, 0
    chunk = SUB * -(-n_entries // (SUB * MAX_CHUNKS))
    groups = -(-(m + 2) // GROUP)
    return chunk, n_entries + groups * (-(-n_entries // chunk) + 1)


def bin_csr_cuda(idx: torch.Tensor, m: int,
                 lo: int | None = None) -> CSRBins:
    """Bin on the card (PyTorch's current stream, no sync), counted as
    ``bloom_csr.bin`` (with ``lo``, the rows [lo, lo + m):
    ``bloom_csr.bin.range``).  idx (T, k) int32, contiguous, on a CUDA
    device.  Raises on anything the kernels do not take."""
    if not idx.is_cuda:
        raise ValueError("idx must lie on a CUDA device")
    if idx.ndim != 2 or idx.dtype != torch.int32:
        raise TypeError(f"need int32 idx (T, k), got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    n, k = idx.numel(), idx.shape[1]
    if n >= 2 ** 30 or not 0 <= m < 2 ** 30:
        raise ValueError(f"need T*k < 2**30 and 0 <= m < 2**30, got "
                         f"T*k={n} m={m}")
    if lo is not None and not 0 <= lo < 2 ** 30:
        raise ValueError(f"need 0 <= lo < 2**30, got {lo}")
    if n > SMALL_ENTRIES and (m + 2 > GROUP * MAX_GROUPS
                              or n > MAX_GROUPED_ENTRIES):
        raise ValueError(f"more than {SMALL_ENTRIES} entries need m <= "
                         f"{GROUP * MAX_GROUPS - 2} and T*k <= "
                         f"{MAX_GROUPED_ENTRIES}, got T*k={n} m={m}")
    chunk, n_scratch = bin_plan(n, m)
    row_ptr = torch.empty(m + 1, dtype=torch.int32, device=idx.device)
    src = torch.empty(n, dtype=torch.int32, device=idx.device)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=idx.device)
    lib = _library()
    err = lib.bloom_csr_bin(idx.data_ptr(), n, max(k, 1), m, lo or 0, chunk,
                            row_ptr.data_ptr(), src.data_ptr(),
                            scratch.data_ptr(),
                            torch.cuda.current_stream(idx.device).cuda_stream)
    _raise_on(lib, err)
    common.count_launch(BIN if lo is None else BIN_RANGE)
    return CSRBins(row_ptr, src)


def bin_csr(idx: torch.Tensor, m: int, lo: int | None = None) -> CSRBins:
    """The bins of idx (T, k) over m rows (with ``lo``: the rows [lo,
    lo + m)): on the card for a CUDA tensor, with torch ops for a CPU
    tensor."""
    if common.resolve_impl(idx) == "kernel":
        return bin_csr_cuda(idx, m, lo)
    return bin_csr_plain(idx, m, lo)


def rows_per_block(m: int, D: int, vec: bool, n_sm: int) -> int:
    """Rows a scatter block owns: up to ``PAIRS_PER_BLOCK`` (row, chunk)
    pairs (a chunk is 4 columns on the vector path, 1 on the scalar one),
    halved while the grid has fewer than 4 blocks per SM and a block keeps
    a pair for each thread."""
    cpr = D // 4 if vec else D
    rows = max(1, min(MAX_ROWS, PAIRS_PER_BLOCK // max(cpr, 1)))
    while rows > 1 and -(-m // rows) < 4 * n_sm and rows * cpr > THREADS:
        rows //= 2
    return rows


def min_bytes(n_entries: int, n_tokens: int, m: int, D: int,
              itemsize: int) -> int:
    """The least device-memory traffic of one call: the (m, D) f32 output
    once, each distinct cotangent row once (``n_tokens`` of them), and the
    int32 row pointers and entries."""
    return int(m * D * 4 + n_tokens * D * itemsize + (m + 1) * 4
               + n_entries * 4)


def bin_min_bytes(n_entries: int, m: int) -> int:
    """The least device-memory traffic of one binning: the int32 entries
    read once, and the row pointers and ``src`` written once."""
    return int(4 * (2 * n_entries + m + 1))


def _check_shapes(g: torch.Tensor, idx: torch.Tensor) -> None:
    if g.ndim != 2 or idx.ndim != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"need g (T, D) and idx (T, k), got "
                         f"{tuple(g.shape)} and {tuple(idx.shape)}")


def csr_scatter_add_plain(g: torch.Tensor, bins: CSRBins,
                          m: int) -> torch.Tensor:
    """The plain PyTorch version: (m, D) f32 on g's device.  Entries
    outside every segment (values outside [0, m)) are skipped, as the
    kernel skips them (added into a spare row m that is cut off, so no
    host sync is needed)."""
    pos = torch.arange(bins.src.numel(), device=g.device)
    rows = torch.searchsorted(bins.row_ptr.long(), pos, right=True) - 1
    rows = torch.where(rows < 0, m, rows)
    out = torch.zeros(m + 1, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, rows, g.float()[bins.src.long()])[:m]


def csr_scatter_add_cuda(g: torch.Tensor, bins: CSRBins,
                         m: int, name: str = NAME) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream (no sync),
    counted under ``name``.

    g (T, D) float32 or bfloat16, contiguous, and ``bins`` from
    ``bin_csr`` over m rows, on one CUDA device.  Raises on anything the
    kernel does not take."""
    row_ptr, src = bins.row_ptr, bins.src
    if not (g.is_cuda and row_ptr.device == g.device
            and src.device == g.device):
        raise ValueError("g and the bins must lie on one CUDA device")
    if g.dtype not in DTYPES or row_ptr.dtype != torch.int32 \
            or src.dtype != torch.int32:
        raise TypeError(f"need a float32 or bfloat16 g and int32 bins, got "
                        f"{g.dtype}, {row_ptr.dtype} and {src.dtype}")
    if not (g.is_contiguous() and row_ptr.is_contiguous()
            and src.is_contiguous()):
        raise ValueError("g and the bins must be contiguous")
    if g.ndim != 2 or row_ptr.shape != (m + 1,):
        raise ValueError(f"need g (T, D) and row_ptr ({m + 1},), got "
                         f"{tuple(g.shape)} and {tuple(row_ptr.shape)}")
    D = g.shape[1]
    if src.numel() >= 2 ** 31 or D >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"need T*k, D, m < 2**31, got T*k={src.numel()} "
                         f"D={D} m={m}")
    out = torch.empty((m, D), dtype=torch.float32, device=g.device)
    if m == 0 or D == 0:
        return out
    lib = _library()
    fn = lib.bloom_csr_f32 if g.dtype == torch.float32 else lib.bloom_csr_bf16
    vec = (D % 4 == 0 and g.data_ptr() % (4 * g.element_size()) == 0
           and out.data_ptr() % 16 == 0)
    n_sm = torch.cuda.get_device_properties(g.device).multi_processor_count
    err = fn(g.data_ptr(), row_ptr.data_ptr(), src.data_ptr(),
             out.data_ptr(), m, D, rows_per_block(m, D, vec, n_sm),
             torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err)
    common.count_launch(name)
    return out


def csr_scatter_add(g: torch.Tensor, idx: torch.Tensor,
                    m: int, lo: int | None = None) -> torch.Tensor:
    """Bin ``idx`` and scatter-add ``g``: the kernel for CUDA tensors, the
    plain version for CPU tensors.  (m, D) f32, with ``lo`` the rows
    [lo, lo + m) of the table."""
    _check_shapes(g, idx)
    if common.resolve_impl(g, idx) == "kernel":
        return csr_scatter_add_cuda(g, bin_csr(idx, m, lo), m)

    def plain():
        return csr_scatter_add_plain(g, bin_csr_plain(idx, m, lo), m)

    return common.run_plain(
        NAME,
        lambda: (bin_min_bytes(idx.numel(), m)
                 + min_bytes(idx.numel(), g.shape[0], m, g.shape[1],
                             g.element_size())), plain)


def bloom_decode_bwd_csr(g: torch.Tensor, H: torch.Tensor, m: int,
                        bins: CSRBins | None = None) -> torch.Tensor:
    """g (B, d) cotangent of the Eq. 3 scores; H (d, k) -> dlogp (B, m)
    f32 = the scatter-add of g's transpose with H's bins (``bin_csr(H, m)``
    when ``bins`` is None): dlogp.T[c] = sum over (i, j) with H[i, j] == c
    of g.T[i].  The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if g.ndim != 2 or H.ndim != 2 or g.shape[1] != H.shape[0]:
        raise ValueError(f"need g (B, d) and H (d, k), got "
                         f"{tuple(g.shape)} and {tuple(H.shape)}")
    impl = common.resolve_impl(g, H)
    if bins is None:
        bins = bin_csr(H, m)
    gt = g.t().contiguous()
    if impl == "kernel":
        return csr_scatter_add_cuda(gt, bins, m, DECODE).t()
    return csr_scatter_add_plain(gt, bins, m).t()


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.bloom_csr_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = common.load_library(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bloom_csr_f32, lib.bloom_csr_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    lib.bloom_csr_bin.argtypes = [p, i, i, i, i, i, p, p, p, p]
    lib.bloom_csr_bin.restype = i
    lib.bloom_csr_error_string.argtypes = [i]
    lib.bloom_csr_error_string.restype = ctypes.c_char_p
    return lib
