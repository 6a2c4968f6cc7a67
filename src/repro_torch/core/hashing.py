"""Hash-function substrate for Bloom embeddings.

The paper (Sec. 3.1/3.2) requires k independent hash functions H = {H_j},
each mapping item ids [0, d) -> [0, m).  Two interchangeable realizations:

1. **On-the-fly enhanced double hashing** (Dillinger & Manolios 2004, cited
   by the paper):  ``h_j(x) = (a(x) + j*b(x) + (j^3 - j)/6) mod m`` with
   ``a, b`` derived from a strong integer mixer.  O(1) space, O(k) time.

2. **Precomputed hash matrix** ``H`` of shape (d, k) — the paper's
   "pre-generate all projections for all d items ... d x k matrix of
   integers between 1 and m" mode, with a vectorized within-row
   de-duplication pass (the paper draws without replacement); any residual
   duplicate after the repair rounds is a benign Bloom collision.

All arithmetic is uint32 with wraparound, bit-identical to the JAX
package's ``core/hashing.py``.  PyTorch has no uint32 remainder on every
device, so values are held in int64 tensors and masked with ``& MASK``
after every step that can leave 32 bits: an int64 product may wrap, but
its low 32 bits are exact.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix finalizer — a high-quality 32-bit integer mixer.

    Accepts any integer tensor (negative values mix by their uint32 bit
    pattern); returns int64 holding the uint32 mixed bits.
    """
    z = ((x.to(torch.int64) & MASK) + _GOLDEN) & MASK
    z = ((z ^ (z >> 16)) * _MIX1) & MASK
    z = ((z ^ (z >> 13)) * _MIX2) & MASK
    return z ^ (z >> 16)


def _mix_int(x: int) -> int:
    """splitmix32 of one Python int (masked 32-bit arithmetic)."""
    z = (x + _GOLDEN) & MASK
    z = ((z ^ (z >> 16)) * _MIX1) & MASK
    z = ((z ^ (z >> 13)) * _MIX2) & MASK
    return z ^ (z >> 16)


def _salted(ids: torch.Tensor, salt: int) -> torch.Tensor:
    """Mix item ids with a salt; different salts give independent streams."""
    return splitmix32((ids.to(torch.int64) & MASK) ^ _mix_int(salt & MASK))


def double_hash_salts(seed: int) -> tuple[int, int]:
    """``(splitmix32(2*seed), splitmix32(2*seed+1))`` as ints: the two mixed
    salt constants double_hash folds into every id."""
    return _mix_int(2 * seed & MASK), _mix_int((2 * seed + 1) & MASK)


def double_hash(ids: torch.Tensor, k: int, m: int,
                seed: int = 0) -> torch.Tensor:
    """Enhanced double hashing: k indices in [0, m) per id.

    h_j = (h1 + j*h2 + (j^3 - j)/6) mod m, with h2 forced odd/nonzero so the
    probe sequence cycles through residues.  Returns shape ids.shape + (k,)
    int32.  Negative ids (padding) hash like their bit pattern — callers
    mask them out themselves.
    """
    h1 = _salted(ids, 2 * seed) % m
    h2 = _salted(ids, 2 * seed + 1) % max(m - 1, 1) + 1
    j = torch.arange(k, dtype=torch.int64, device=ids.device)
    # (j^3 - j)/6 % m from j on the device: no host-to-device copy, which
    # would synchronise the host with the device on every call
    tri = (j * j * j - j) // 6 % m
    h = (h1[..., None] + ((j * h2[..., None]) & MASK)) & MASK
    h = ((h + tri) & MASK) % m
    return h.to(torch.int32)


def _hash_matrix_impl(d: int, k: int, m: int, seed: int, repair_rounds: int,
                      device) -> torch.Tensor:
    ids = torch.arange(d, dtype=torch.int64, device=device)
    h = double_hash(ids, k, m, seed)  # (d, k)
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool, device=device),
                       diagonal=-1)   # i < j
    for r in range(repair_rounds):
        # dup[j] = True iff h[j] equals some h[i], i < j (within the row).
        eq = h[:, :, None] == h[:, None, :]              # (d, k, k)
        dup = torch.any(eq & lower.T[None, :, :], dim=-1)
        fresh = double_hash((ids + (r + 1) * 0x1000_0003) & MASK, k, m,
                            seed + 7919 * (r + 1))
        h = torch.where(dup, fresh, h)
    return h.to(torch.int32)


def make_hash_matrix(d: int, k: int, m: int, seed: int = 0,
                     repair_rounds: int = 4, device=None) -> torch.Tensor:
    """Precompute the paper's (d, k) hash matrix H of indices in [0, m).

    Rows are de-duplicated with `repair_rounds` vectorized redraw passes;
    residual within-row duplicates have probability ~(k^2/2m)^rounds and are
    benign (they only weaken one item's Bloom code slightly).
    """
    if m <= 0 or d <= 0 or k <= 0:
        raise ValueError(f"d, k, m must be positive; got {d=} {k=} {m=}")
    if k > m:
        raise ValueError(f"k ({k}) cannot exceed m ({m})")
    return _hash_matrix_impl(d, k, m, seed, repair_rounds, device)


def make_hash_matrix_np(d: int, k: int, m: int, seed: int = 0,
                        strict: bool = True) -> np.ndarray:
    """NumPy hash matrix with *guaranteed* distinct entries per row.

    Used by CBE (host-side preprocessing) and by tests as an oracle.  Loops
    only over residual collisions, so it is fast for realistic (d, k, m).
    """
    if k > m:
        raise ValueError(f"k ({k}) cannot exceed m ({m})")
    rng = np.random.default_rng(seed)
    h = rng.integers(0, m, size=(d, k), dtype=np.int64)
    if strict:
        for _ in range(64):
            srt = np.sort(h, axis=1)
            bad_rows = np.nonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))[0]
            if bad_rows.size == 0:
                break
            h[bad_rows] = rng.integers(0, m, size=(bad_rows.size, k))
        else:  # pragma: no cover - probabilistically unreachable
            for r in np.nonzero(
                (np.sort(h, 1)[:, 1:] == np.sort(h, 1)[:, :-1]).any(1))[0]:
                h[r] = rng.choice(m, size=k, replace=False)
    return h.astype(np.int32)


def hash_indices(ids: torch.Tensor, *, k: int, m: int, seed: int = 0,
                 hash_matrix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unified lookup: per-id k hash indices, from H if given else on-the-fly.

    ids: int tensor, any shape; returns ids.shape + (k,) int32 in [0, m).
    Negative ids are clamped to 0 for the matrix path — callers must mask.
    """
    if hash_matrix is not None:
        safe = torch.clamp(ids.long(), 0, hash_matrix.shape[0] - 1)
        return hash_matrix[safe]
    return double_hash(ids, k, m, seed)
