"""Bloom embedding: the k-way row gather-sum of the token input, and its
backward.

For a table (m, D) and hash indices idx (T, k) int32 in [0, m):
``out[t, :] = sum_j row(idx[t, j])``, summed in f32 in j order from row 0
and rounded once to the output dtype.  ``row(r)`` is the table's row r
widened to f32; a quantized table (``table_dtype``, core/quant.py) stores
rows narrow — bf16, fp8 e4m3, or int8 with one f32 scale per row, where
``row(r) = q[r] * scales[r]``.  The gradient is the scatter-add of the
cotangent into the master table's dtype, by ``bwd_impl``: the CSR
scatter-add (``kernels/bloom_csr.py``, "csr") or the dense m-tile sweep
(``bloom_embed_bwd``, "dense"); with a quantized forward it is
straight-through (the exact gradient of the unquantized gather-sum), as
the reference's custom VJP does.

* ``bloom_embed_cuda`` / ``bloom_embed_quantized_cuda`` launch the
  hand-written Hopper kernel (``csrc/bloom_embed.cu``, which replaces the
  JAX package's Pallas ``bloom_embed_pallas`` forward and its quantized
  ``_fwd_kernel_scaled`` / ``bloom_embed_fwd_quantized``) on CUDA tensors
  over (T, k) hash indices, and count their launches: ``bloom_embed`` for
  a table read as it is (output in its dtype), ``bloom_embed.<storage>``
  for a quantized one.
* The token entry, the one the model's path takes
  (``bloom_embed_tokens_cuda`` / ``bloom_embed_tokens_quantized_cuda``):
  the same kernel from (T,) token ids and a ``BloomSpec``, hashing in the
  kernel as ``spec.indices_for`` does (one launch, no index tensor, no
  host sync), and, when autograd needs them, writing the (T, k) indices
  beside the output.  Counted as the entry above plus the spec's kind
  (``token_variant_name``): ``.hash`` (on-the-fly double hash), ``.H``
  (a row of the precomputed hash matrix) or ``.id`` (the identity spec).
* ``bloom_embed_plain`` / ``bloom_embed_quantized_plain`` /
  ``bloom_embed_tokens_plain`` are the same forwards in plain PyTorch on
  any device (the token one through ``spec.indices_for``): the CPU path,
  and what the kernel is held against on the card.
* ``bloom_embed_fwd_quantized`` / ``bloom_embed_tokens_fwd_quantized``
  are the forward-only serving entries on a pre-quantized table
  (``core.bloom.cached_quantized_table``).
* ``bloom_embed_bwd_cuda`` launches the dense backward kernel (same
  source; replaces ``bloom_embed_bwd_pallas``), counted as
  ``bloom_embed_bwd``: ``dtable[r] = sum over (t, j) with idx[t, j] == r
  of g[t]``, summed in (t, j) order from 0.0 with no float atomics, so it
  equals the CSR kernel bit for bit.  ``bloom_embed_bwd_plain`` is the
  same sum as ``zeros(m, D).index_add_`` over the entries in (t, j) order
  (the kernel's order on the CPU, where ``index_add_`` adds in index
  order); ``bloom_embed_bwd`` picks one by the tensors' device.
* ``bloom_embed`` is the differentiable entry: an ``autograd.Function``
  over (T, k) indices, or with ``spec`` over (T,) token ids, whose forward
  picks kernel or plain version by the tensors' device
  (kernels.common.resolve_impl: CUDA tensors launch the kernel or raise),
  quantizing the table first when ``table_dtype`` is given, and whose
  backward is ``bloom_csr.csr_scatter_add`` (``bwd_impl="csr"``) or
  ``bloom_embed_bwd`` (``"dense"``): the kernel on CUDA, its plain version
  on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.bloom import BloomSpec, cached_hash_matrix
from repro_torch.kernels import bloom_csr, common

NAME = "bloom_embed"
BWD = "bloom_embed_bwd"
DTYPES = (torch.float32, torch.bfloat16)     # also the output dtypes
# the storage dtype codes of csrc/bloom_embed.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}
# where the kernel's indices come from (csrc/bloom_embed.cu's Src): a
# (T, k) index matrix, or token ids and the spec's kind
_SRC_IDX = 0
_SRC = {"hash": 1, "H": 2, "id": 3}


def min_bytes(n_rows: int, T: int, k: int, D: int, itemsize: int,
              out_itemsize: Optional[int] = None,
              row_scales: bool = False, token_itemsize: int = 0) -> int:
    """The least device-memory traffic of one call: the ``n_rows``
    distinct gathered table rows once (at the stored ``itemsize``, plus one
    f32 scale each for int8), the (T, k) int32 indices once, or for the
    token entry the T token ids at ``token_itemsize`` bytes each, and the
    (T, D) output once (at ``out_itemsize``, default ``itemsize``)."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    ids = T * token_itemsize if token_itemsize else T * k * 4
    return int(n_rows * D * itemsize + (n_rows * 4 if row_scales else 0)
               + ids + T * D * out_itemsize)


def variant_name(qtable_dtype: torch.dtype) -> str:
    """Launch-count name of the quantized forward on this storage."""
    return f"{NAME}.{quant.storage_name(qtable_dtype)}"


def spec_kind(spec: BloomSpec) -> str:
    """How ``spec.indices_for`` makes a token's indices: "id" (the
    identity spec, m == d and k == 1), "hash" (the on-the-fly double
    hash) or "H" (a row of the precomputed hash matrix)."""
    if spec.m == spec.d and spec.k == 1:
        return "id"
    return "hash" if spec.on_the_fly else "H"


def token_variant_name(spec: BloomSpec,
                       qtable_dtype: Optional[torch.dtype] = None) -> str:
    """Launch-count name of the token entry: ``bloom_embed.<kind>`` for a
    table read as it is, ``bloom_embed.<storage>.<kind>`` for a quantized
    one."""
    base = NAME if qtable_dtype is None else variant_name(qtable_dtype)
    return f"{base}.{spec_kind(spec)}"


def _check_shapes(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"need table (m, D) and idx (T, k), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.shape[1] < 1:
        raise ValueError("need k >= 1 hash indices per token")


def _check_quantized(qtable: torch.Tensor, scales: Optional[torch.Tensor],
                     idx: torch.Tensor, out_dtype: torch.dtype) -> None:
    _check_shapes(qtable, idx)
    _check_storage(qtable, scales, out_dtype)


def _check_storage(qtable: torch.Tensor, scales: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> None:
    if qtable.ndim != 2:
        raise ValueError(f"need table (m, D), got {tuple(qtable.shape)}")
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


def bloom_embed_tokens_plain(qtable: torch.Tensor,
                             scales: Optional[torch.Tensor],
                             tokens: torch.Tensor, spec: BloomSpec,
                             out_dtype: torch.dtype = torch.float32):
    """The token entry in plain PyTorch: ``spec.indices_for(tokens)`` and
    the gather-sum over the stored table.  Returns ((T, D) in
    ``out_dtype``, the (T, k) int32 indices)."""
    idx = spec.indices_for(tokens).contiguous()
    return bloom_embed_quantized_plain(qtable, scales, idx, out_dtype), idx


def _launch(qtable: torch.Tensor, scales: Optional[torch.Tensor],
            ids: torch.Tensor, out_dtype: torch.dtype, name: str,
            spec: Optional[BloomSpec] = None, want_idx: bool = False,
            defines: tuple = ()):
    """Check the tensors, allocate the output and launch on the current
    stream (no sync), counting the launch as ``name``; an empty output
    (T or D zero) launches and counts nothing.  ``ids`` is (T, k) int32
    indices, or with ``spec`` the (T,) int32 or int64 token ids;
    ``defines`` picks a build of the kernel (``_library``).  Returns (out,
    the (T, k) int32 indices when ``want_idx``, else None)."""
    tensors = (qtable, ids) if scales is None else (qtable, ids, scales)
    if not all(t.is_cuda and t.device == qtable.device for t in tensors):
        raise ValueError("table, scales and idx must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, scales and idx must be contiguous")
    m, D = qtable.shape
    dev = qtable.device
    if spec is None:
        if ids.dtype != torch.int32:
            raise TypeError(f"need int32 idx, got {ids.dtype}")
        (T, k), src, H, consts = ids.shape, _SRC_IDX, None, (0,) * 6
    else:
        if ids.ndim != 1 or ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"need (T,) int32 or int64 token ids, got "
                            f"{tuple(ids.shape)} {ids.dtype}")
        if spec.m != m:
            raise ValueError(f"the spec's m={spec.m} is not the table's "
                             f"{m} rows")
        T, k, kind = ids.shape[0], spec.k, spec_kind(spec)
        src = _SRC[kind]
        H = cached_hash_matrix(spec, dev) if kind == "H" else None
        consts = common.hash_constants(m, spec.seed)
    if T * k >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"need T*k, D < 2**31, got T*k={T * k} D={D}")
    out = torch.empty((T, D), dtype=out_dtype, device=dev)
    idx = (torch.empty((T, k), dtype=torch.int32, device=dev)
           if want_idx and spec is not None else None)
    if T == 0 or D == 0:
        if idx is not None and T:
            idx.copy_(spec.indices_for(ids))
        return out, idx
    lib = _library(defines)
    err = lib.bloom_embed_fwd(
        qtable.data_ptr(), None if scales is None else scales.data_ptr(),
        ids.data_ptr(), int(ids.dtype == torch.int64), src,
        None if H is None else H.data_ptr(),
        None if idx is None else idx.data_ptr(), out.data_ptr(), T, D, k, m,
        0 if spec is None else spec.d, *consts, _CODES[qtable.dtype],
        _CODES[out_dtype], common.sm_count(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.bloom_embed_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    common.count_launch(name)
    return out, idx


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
    out, _ = _launch(table, None, idx, table.dtype, NAME)
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
    out, _ = _launch(qtable, scales, idx, out_dtype,
                     variant_name(qtable.dtype))
    return out


def bloom_embed_tokens_cuda(table: torch.Tensor, tokens: torch.Tensor,
                            spec: BloomSpec, want_idx: bool = False):
    """The token entry on a table read as it is (float32 or bfloat16,
    output in its dtype): one launch from the (T,) int32 or int64 token
    ids, hashed in the kernel as ``spec.indices_for`` does; counted as
    ``token_variant_name(spec)``.  Returns (out, the (T, k) int32 indices
    of ``spec.indices_for`` when ``want_idx``, else None).  Raises on
    anything the kernel does not take."""
    if table.ndim != 2:
        raise ValueError(f"need table (m, D), got {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"need a float32 or bfloat16 table, got "
                        f"{table.dtype}")
    return _launch(table, None, tokens, table.dtype,
                   token_variant_name(spec), spec, want_idx)


def bloom_embed_tokens_quantized_cuda(qtable: torch.Tensor,
                                      scales: Optional[torch.Tensor],
                                      tokens: torch.Tensor, spec: BloomSpec,
                                      out_dtype: torch.dtype = torch.float32,
                                      want_idx: bool = False):
    """The token entry over a stored table (as
    ``bloom_embed_quantized_cuda``), counted as
    ``token_variant_name(spec, qtable.dtype)``.  Returns (out, indices or
    None) as ``bloom_embed_tokens_cuda`` does."""
    _check_storage(qtable, scales, out_dtype)
    return _launch(qtable, scales, tokens, out_dtype,
                   token_variant_name(spec, qtable.dtype), spec, want_idx)


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


def bloom_embed_tokens_fwd_quantized(qtable: torch.Tensor,
                                     scales: Optional[torch.Tensor],
                                     tokens: torch.Tensor, spec: BloomSpec,
                                     out_dtype: torch.dtype = torch.float32
                                     ) -> torch.Tensor:
    """``bloom_embed_fwd_quantized`` from (T,) token ids: the token kernel
    for CUDA tensors, ``bloom_embed_tokens_plain`` for CPU tensors."""
    if common.resolve_impl(qtable, scales, tokens) == "kernel":
        return bloom_embed_tokens_quantized_cuda(qtable, scales, tokens,
                                                 spec, out_dtype)[0]
    return bloom_embed_tokens_plain(qtable, scales, tokens, spec,
                                    out_dtype)[0]


def default_out_dtype(table_dtype: Optional[str],
                      table: torch.Tensor) -> torch.dtype:
    """The output dtype when the caller leaves it implicit: the table's
    own without quantization; f32 or bf16 storage keeps its dtype; the
    1-byte storages widen to f32 (the reference's ``_default_out_dtype``)."""
    if table_dtype is None:
        return table.dtype
    st = quant.storage_dtype(table_dtype)
    return st if st in DTYPES else torch.float32


def _check_bwd(g: torch.Tensor, idx: torch.Tensor) -> None:
    if g.ndim != 2 or idx.ndim != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"need g (T, D) and idx (T, k), got "
                         f"{tuple(g.shape)} and {tuple(idx.shape)}")


def bloom_embed_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                          m: int) -> torch.Tensor:
    """The plain PyTorch dense backward: (m, D) f32 on g's device, each row
    summed over the entries in (t, j) order (on the CPU; on a CUDA tensor
    ``index_add_`` adds with atomics).  Entries outside [0, m) never
    match (they add into a spare row m that is cut off)."""
    _check_bwd(g, idx)
    T, k = idx.shape
    flat = idx.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < m), flat, m)
    src = torch.arange(T, device=g.device).repeat_interleave(k)
    out = torch.zeros(m + 1, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, flat, g.float()[src])[:m]


def bloom_embed_bwd_cuda(g: torch.Tensor, idx: torch.Tensor,
                         m: int) -> torch.Tensor:
    """Launch the dense backward kernel on PyTorch's current stream (no
    sync).  g (T, D) float32 or bfloat16 and idx (T, k) int32, contiguous,
    on one CUDA device; (m, D) f32.  Raises on anything the kernel does not
    take."""
    _check_bwd(g, idx)
    if not (g.is_cuda and idx.device == g.device):
        raise ValueError("g and idx must lie on one CUDA device")
    if g.dtype not in DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"need a float32 or bfloat16 g and int32 idx, got "
                        f"{g.dtype} and {idx.dtype}")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("g and idx must be contiguous")
    (T, D), k = g.shape, idx.shape[1]
    if T * k >= 2 ** 31 or T * D >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"need T*k, T*D, m < 2**31, got T*k={T * k} "
                         f"T*D={T * D} m={m}")
    out = torch.empty((m, D), dtype=torch.float32, device=g.device)
    if m and D:
        lib = _library()
        err = lib.bloom_embed_bwd_dense(
            g.data_ptr(), _CODES[g.dtype], idx.data_ptr(), out.data_ptr(),
            T, D, m, k, torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            msg = lib.bloom_embed_error_string(err).decode()
            raise RuntimeError(f"{BWD} kernel launch failed: CUDA error "
                               f"{err} ({msg})")
        common.count_launch(BWD)
    return out


def bloom_embed_bwd(g: torch.Tensor, idx: torch.Tensor,
                    m: int) -> torch.Tensor:
    """The dense backward: the kernel for CUDA tensors, the plain version
    for CPU tensors.  (m, D) f32."""
    if common.resolve_impl(g, idx) == "kernel":
        return bloom_embed_bwd_cuda(g, idx, m)
    return bloom_embed_bwd_plain(g, idx, m)


def _forward(table, ids, spec, table_dtype, out_dtype, want_idx):
    """The forward of ``bloom_embed``: (out, the indices its backward
    reads, or None for the token entry without ``want_idx``)."""
    kernel = common.resolve_impl(table, ids) == "kernel"
    if table_dtype is None:
        q, scales, od = table, None, table.dtype
    else:
        q, scales = quant.quantize_table(table, table_dtype)
        od = out_dtype or default_out_dtype(table_dtype, table)
    if spec is None:
        if not kernel:
            return bloom_embed_quantized_plain(q, scales, ids, od), ids
        if table_dtype is None:
            return bloom_embed_cuda(q, ids), ids
        return bloom_embed_quantized_cuda(q, scales, ids, od), ids
    if not kernel:
        return bloom_embed_tokens_plain(q, scales, ids, spec, od)
    if table_dtype is None:
        return bloom_embed_tokens_cuda(q, ids, spec, want_idx)
    return bloom_embed_tokens_quantized_cuda(q, scales, ids, spec, od,
                                             want_idx)


class _BloomEmbed(torch.autograd.Function):
    """(T, D) forward from (T, k) indices, or with a spec from (T,) token
    ids; the backward returns dtable (m, D) in the master table's dtype
    (straight-through when the forward was quantized)."""

    @staticmethod
    def forward(ctx, table, ids, spec, table_dtype, out_dtype, bwd_impl):
        out, idx = _forward(table, ids, spec, table_dtype, out_dtype, True)
        ctx.save_for_backward(idx)
        ctx.m, ctx.dtype, ctx.bwd_impl = table.shape[0], table.dtype, bwd_impl
        return out

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        scatter = (bloom_csr.csr_scatter_add if ctx.bwd_impl == "csr"
                   else bloom_embed_bwd)
        dtable = scatter(g.contiguous(), idx, ctx.m)
        return dtable.to(ctx.dtype), None, None, None, None, None


def bloom_embed(table: torch.Tensor, idx: torch.Tensor,
                table_dtype: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None,
                bwd_impl: str = "csr",
                spec: Optional[BloomSpec] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in ``table`` through the CSR scatter-add
    (``bwd_impl="csr"``) or the dense backward (``"dense"``).

    ``idx`` is (T, k) int32 hash indices, or, with ``spec``, the (T,)
    token ids that the kernel hashes itself (the token entry; the indices
    the backward needs come out of the same launch, and only when a
    gradient is wanted: grad mode on and ``table`` requiring it).
    ``table_dtype`` (core/quant.py) quantizes the table in the graph and
    gathers the stored rows (straight-through gradient into ``table``);
    ``out_dtype`` sets the output dtype (default ``default_out_dtype``)."""
    td = quant.resolve_table_dtype(table_dtype)
    common.resolve_bwd_impl(bwd_impl)
    if td is None and out_dtype not in (None, table.dtype):
        raise ValueError("out_dtype other than the table's needs a "
                         "table_dtype")
    if not (torch.is_grad_enabled() and table.requires_grad):
        return _forward(table, idx, spec, td, out_dtype, False)[0]
    return _BloomEmbed.apply(table, idx, spec, td, out_dtype, bwd_impl)


@functools.lru_cache(maxsize=None)
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernels' library, built with the extra ``-D`` flags
    ``defines`` (none on every path of the package)."""
    lib = common.load_library(NAME, defines)
    p, i = ctypes.c_void_p, ctypes.c_int
    u = ctypes.c_uint
    lib.bloom_embed_fwd.argtypes = [p, p, p, i, i, p, p, p, i, i, i, i, i,
                                    u, u, u, u, u, u, i, i, i, p]
    lib.bloom_embed_fwd.restype = i
    lib.bloom_embed_launch_floor.argtypes = [p]
    lib.bloom_embed_launch_floor.restype = i
    lib.bloom_embed_bwd_dense.argtypes = [p, i, p, p, i, i, i, i, p]
    lib.bloom_embed_bwd_dense.restype = i
    lib.bloom_embed_error_string.argtypes = [i]
    lib.bloom_embed_error_string.restype = ctypes.c_char_p
    return lib
