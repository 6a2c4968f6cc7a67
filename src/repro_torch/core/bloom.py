"""Bloom embeddings (paper Sec. 3.2): encode and recover.

Terminology follows the paper:
  d  — original (vocab / item-catalogue) dimensionality,
  m  — embedding dimensionality, m < d,
  k  — number of hash projections,
  p  — the set of active positions of a sparse instance x (padded, mask -1),
  u  — the Bloom-encoded binary vector, u[H_j(p_i)] = 1        (Eq. 1),
  v̂  — the model's m-dim softmax output,
  L(q_i) = prod_j v̂[H_j(q_i)]   (Eq. 2)  /  -sum_j log v̂[..]   (Eq. 3).

Everything here is plain PyTorch (the oracle path).  The fused kernel lives
in repro_torch.kernels and is checked against these functions.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import hashing, quant


@dataclasses.dataclass(frozen=True)
class BloomSpec:
    """Static description of one Bloom-embedded IO boundary."""

    d: int                    # original dimensionality (vocab size)
    m: int                    # compressed dimensionality
    k: int = 4                # number of hash projections (paper: 2..4 best)
    seed: int = 0
    on_the_fly: bool = True   # double-hash per call vs precomputed H matrix

    def __post_init__(self):
        if not (0 < self.m <= self.d):
            raise ValueError(f"need 0 < m <= d, got m={self.m} d={self.d}")
        if not (1 <= self.k <= self.m):
            raise ValueError(f"need 1 <= k <= m, got k={self.k} m={self.m}")

    @property
    def compression(self) -> float:
        return self.m / self.d

    def hash_matrix(self, device=None) -> torch.Tensor:
        """(d, k) int32 hash matrix (paper's RAM-cached mode)."""
        return hashing.make_hash_matrix(self.d, self.k, self.m, self.seed,
                                        device=device)

    def indices_for(self, ids: torch.Tensor,
                    hash_matrix: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """ids (...,) -> (..., k) hash indices in [0, m)."""
        if self.m == self.d and self.k == 1 and hash_matrix is None:
            # no-compression spec: the identity map (the paper's Baseline)
            return ids[..., None].to(torch.int32)
        if hash_matrix is None and not self.on_the_fly:
            hash_matrix = self.hash_matrix(ids.device)
        return hashing.hash_indices(ids, k=self.k, m=self.m, seed=self.seed,
                                    hash_matrix=hash_matrix)


def identity_spec(d: int) -> BloomSpec:
    """No-compression spec (m == d, k == 1) — the paper's Baseline."""
    return BloomSpec(d=d, m=d, k=1)


def cached_hash_matrix(spec: BloomSpec, device) -> torch.Tensor:
    """(d, k) int32 whole-vocab hash matrix for `spec` on `device`, built
    once per (spec, device) and shared by every caller: serving decodes the
    same spec every step.  Exactly what ``spec.indices_for`` returns for
    every id (it respects ``on_the_fly``); ~80 MB at d = 10M, k = 2."""
    return _cached_hash_matrix(spec, _device_key(device))


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # one copy per card
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


@functools.lru_cache(maxsize=8)
def _cached_hash_matrix(spec: BloomSpec, device: str) -> torch.Tensor:
    ids = torch.arange(spec.d, dtype=torch.int64, device=device)
    return spec.indices_for(ids).contiguous()


def cached_decode_bins(spec: BloomSpec, device):
    """CSR bins (``kernels.bloom_csr.bin_csr``) of the whole-vocab hash
    matrix, built once per (spec, device) beside the cached matrix they
    bin.  The ``bwd_impl="csr"`` backward of the Eq. 3 decode
    (``kernels.ops.bloom_decode``) scatter-adds the (B, d) cotangent
    through them, so a caller that differentiates the decode (ranking
    losses, gradient sweeps) sorts the d*k entries once, not every step;
    a forward-only caller never builds them.  (The reference keys its
    bins on the spec and its TPU tiling; the port's bins are not tiled.)"""
    return _cached_decode_bins(spec, _device_key(device))


@functools.lru_cache(maxsize=8)
def _cached_decode_bins(spec: BloomSpec, device: str):
    from repro_torch.kernels.bloom_csr import bin_csr   # core -> kernels
    return bin_csr(_cached_hash_matrix(spec, device), spec.m)


_QUANT_CACHE: dict = {}


def cached_quantized_table(spec: BloomSpec, table: torch.Tensor,
                           table_dtype: str):
    """``quant.quantize_table(table, table_dtype)`` for a frozen-params
    caller, cached per (spec, table_dtype, device): serving reads the same
    embedding table every step.

    A hit needs the very same table tensor at the same in-place version
    (``_version``): params swapped under the same spec (a checkpoint
    reload) or updated in place (the port's train step writes into its
    params) miss and requantize, so the cache never serves stale values.
    A table without a version counter (an inference-mode tensor) is
    quantized on every call."""
    td = quant.resolve_table_dtype(table_dtype)
    key = (spec, td, str(table.device))
    version = None if table.is_inference() else table._version
    hit = _QUANT_CACHE.get(key)
    if (hit is not None and version is not None and hit[0] is table
            and hit[1] == version):
        return hit[2]
    with torch.no_grad():
        q = quant.quantize_table(table, td)
    if version is not None:
        _QUANT_CACHE[key] = (table, version, q)
    return q


# --------------------------------------------------------------------------
# Encoding (Eq. 1)
# --------------------------------------------------------------------------

def encode(spec: BloomSpec, p: torch.Tensor,
           hash_matrix: Optional[torch.Tensor] = None,
           dtype=torch.float32) -> torch.Tensor:
    """Bloom-encode padded index sets into multi-hot vectors.

    p: (..., c_max) int, padding = -1.  Returns (..., m) in `dtype` with
    u[H_j(p_i)] = 1 for every valid p_i and projection j.  Binary (set, not
    add) semantics, exactly Eq. 1.
    """
    valid = p >= 0
    idx = spec.indices_for(torch.where(valid, p, torch.zeros_like(p)),
                           hash_matrix)                      # (..., c, k)
    flat = idx.reshape(*p.shape[:-1], -1).long()
    mask = valid.repeat_interleave(spec.k, dim=-1).reshape(flat.shape)
    u = torch.zeros((*p.shape[:-1], spec.m), dtype=dtype, device=p.device)
    # scatter 1s; `amax` keeps binary semantics under collisions
    return u.scatter_reduce(-1, flat, mask.to(dtype), reduce="amax")


def encode_dense(spec: BloomSpec, x: torch.Tensor,
                 hash_matrix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode dense binary instances (..., d) -> (..., m):
    u_i = max over the original positions that hash to i.  Oracle only: it
    materializes a (d, k, m) one-hot; production encodes index sets
    (``encode``)."""
    if hash_matrix is None:
        hash_matrix = spec.indices_for(
            torch.arange(spec.d, dtype=torch.int64, device=x.device))
    onehot = torch.nn.functional.one_hot(hash_matrix.long(),
                                         spec.m).to(x.dtype)  # (d, k, m)
    proj = torch.einsum("...d,dkm->...m", x, onehot)
    return torch.clamp_max(proj, 1.0)


# --------------------------------------------------------------------------
# Recovery (Eqs. 2 and 3)
# --------------------------------------------------------------------------

def _gather_sum(log_v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sum_j log_v[..., idx[:, j]], summed in j order -> (..., n)."""
    idx = idx.long()
    s = log_v[..., idx[:, 0]]
    for j in range(1, idx.shape[1]):
        s = s + log_v[..., idx[:, j]]
    return s


def decode_scores(spec: BloomSpec, log_v: torch.Tensor,
                  hash_matrix: Optional[torch.Tensor] = None,
                  item_ids: Optional[torch.Tensor] = None,
                  chunk: int = 8192) -> torch.Tensor:
    """Eq. 3 ranking scores over original items.

    log_v: (..., m) log-probabilities (e.g. log_softmax of model logits).
    Returns (..., d) scores where scores[i] = sum_j log_v[H_j(i)] — larger is
    better; identical ranking to the Eq. 2 product likelihood.

    Chunks the item axis so (..., d, k) never exists for huge d.
    `item_ids` restricts scoring to a subset (e.g. candidates).
    """
    if item_ids is not None:
        return _gather_sum(log_v, spec.indices_for(item_ids, hash_matrix))
    out = []
    for c0 in range(0, spec.d, chunk):
        ids = torch.arange(c0, min(c0 + chunk, spec.d), dtype=torch.int64,
                           device=log_v.device)
        out.append(_gather_sum(log_v, spec.indices_for(ids, hash_matrix)))
    return torch.cat(out, dim=-1)


def decode_topk(spec: BloomSpec, log_v: torch.Tensor, topk: int,
                hash_matrix: Optional[torch.Tensor] = None,
                chunk: int = 8192):
    """Top-k item recovery without materializing all d scores at once.

    Streaming top-k merge over vocab chunks, as the JAX package's
    ``decode_topk`` does it: the running best starts at (-inf, -1) and each
    chunk is concatenated after it; a stable descending sort keeps equal
    scores in ascending id order (the lowest id wins a tie — which also
    means a -inf score loses to the -1 sentinel, as in the reference).
    Returns (values, indices) of shape (..., topk).
    """
    lead = log_v.shape[:-1]
    best_v = torch.full((*lead, topk), -torch.inf, dtype=log_v.dtype,
                        device=log_v.device)
    best_i = torch.full((*lead, topk), -1, dtype=torch.int32,
                        device=log_v.device)
    for c0 in range(0, spec.d, chunk):
        ids = torch.arange(c0, min(c0 + chunk, spec.d), dtype=torch.int64,
                           device=log_v.device)
        s = _gather_sum(log_v, spec.indices_for(ids, hash_matrix))
        cat_v = torch.cat([best_v, s], dim=-1)
        cat_i = torch.cat([best_i, ids.to(torch.int32).expand(s.shape)],
                          dim=-1)
        srt, order = torch.sort(cat_v, dim=-1, descending=True, stable=True)
        best_v = srt[..., :topk]
        best_i = torch.gather(cat_i, -1, order[..., :topk])
    return best_v, best_i


def recover_probabilities(spec: BloomSpec, v_hat: torch.Tensor,
                          hash_matrix: Optional[torch.Tensor] = None,
                          eps: float = 1e-30) -> torch.Tensor:
    """Eq. 2 likelihoods renormalized to a distribution over the d items
    (the paper ranks without renormalizing).  Oracle path: materializes
    (..., d)."""
    log_v = torch.log(torch.clamp(v_hat, eps, 1.0))
    return torch.softmax(decode_scores(spec, log_v, hash_matrix), dim=-1)
