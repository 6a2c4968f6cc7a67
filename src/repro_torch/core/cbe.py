"""Co-occurrence-based Bloom embeddings (paper Sec. 6, Algorithm 1).

CBE 're-directs' the collisions that must happen anyway (m < d) so that the
most co-occurring item pairs share a bit.  Training/serving cost is
unchanged — CBE only produces a different precomputed hash matrix H'.

This is host-side preprocessing (the paper stores H in RAM, not GPU memory),
so it is written in NumPy/SciPy over the sparse instance matrix X: a copy
of the JAX package's ``core/cbe.py``, giving the same integers.  The
matrix it returns goes to ``core.alternatives.BloomIO.build(H_in=...,
H_out=...)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp


def cooccurrence_stats(X: sp.spmatrix):
    """Co-occurrence statistics reported in paper Table 4.

    Returns (percent_cooccurring_pairs, mean_cooccurrence_ratio rho).
    """
    X = X.tocsr().astype(np.float64)
    n, d = X.shape
    C = (X.T @ X).tocoo()
    mask = C.row < C.col                      # strict lower/upper triangle
    vals = C.data[mask]
    vals = vals[vals > 0]
    total_pairs = d * (d - 1) / 2
    pct = 100.0 * vals.size / max(total_pairs, 1)
    rho = float(vals.mean() / n) if vals.size else 0.0
    return pct, rho


def cbe_hash_matrix(
    X: sp.spmatrix,
    H: np.ndarray,
    m: int,
    seed: int = 0,
    max_pairs: Optional[int] = None,
) -> np.ndarray:
    """Algorithm 1: co-occurrence-based hashing matrix H'.

    Args:
      X: (n, d) sparse binary instance matrix (inputs and/or outputs).
      H: (d, k) precomputed hash matrix (core.hashing.make_hash_matrix_np).
      m: embedding dimensionality (range of H entries).
      max_pairs: optional cap on processed pairs (largest co-occurrences are
        processed last and therefore always kept — the cap drops the
        *smallest* entries, which Algorithm 1 would have overwritten anyway).

    Returns a new (d, k) int32 matrix.
    """
    rng = np.random.default_rng(seed)
    H = np.array(H, dtype=np.int64, copy=True)
    d, k = H.shape
    X = X.tocsr().astype(np.float64)

    # line 1: C <- X^T X  (pairwise co-occurrence counts)
    C = (X.T @ X).tocsr()
    # line 2: C <- C ⊙ sgn(C - Avgfreq(X)); Avgfreq = mean item frequency.
    avg_freq = float(X.sum() / d)
    C = C.tocoo()
    data = C.data * np.sign(C.data - avg_freq)
    # line 3: lower triangle in coordinate format.
    tri = C.row > C.col
    vals, rows, cols = data[tri], C.row[tri], C.col[tri]
    keep = vals != 0
    vals, rows, cols = vals[keep], rows[keep], cols[keep]
    # line 4: increasing order => largest co-occurrence processed last, so
    # its collision assignment survives any earlier overwrite.
    order = np.argsort(vals, kind="stable")
    if max_pairs is not None and order.size > max_pairs:
        order = order[-max_pairs:]

    for i in order:
        a, b = int(rows[i]), int(cols[i])
        used = set(H[a]) | set(H[b])
        if len(used) >= m:       # degenerate tiny-m case: nothing to redirect
            continue
        # line 6: r <- URND(1, m, h_a ∪ h_b)
        while True:
            r = int(rng.integers(0, m))
            if r not in used:
                break
        # lines 7-9: pick projections and redirect both to bit r.
        ja = int(rng.integers(0, k))
        jb = int(rng.integers(0, k))
        H[a, ja] = r
        H[b, jb] = r
    return H.astype(np.int32)
