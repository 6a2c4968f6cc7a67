"""The four alternative IO embeddings the paper compares against (Sec.
4.3): HT, ECOC, PMI and CCA, and the interface they and Bloom embeddings
share, so a trainer or a benchmark can swap them freely.

Every fit runs on the host in NumPy/SciPy, as preprocessing (like the
paper's hash matrix), and gives the same integers and arrays as the JAX
package's ``core/alternatives.py``; encode, loss and decode are PyTorch
on the device the embedding was built for (``build(..., device=)``: CUDA
unless the caller asks for the CPU, a raise when CUDA is absent).  A
Bloom embedding's Eq. 3 decode (``eq3_scores``) is the hand-written
``bloom_decode`` kernel on a CUDA tensor (``kernels.ops.bloom_decode``)
and the plain ``core.bloom.decode_scores`` on a CPU tensor: the same
function, summed in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from repro_torch.core import losses
from repro_torch.core.bloom import BloomSpec, decode_scores
from repro_torch.core.bloom import encode as bloom_encode
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device


# --------------------------------------------------------------------------
# Shared interface
# --------------------------------------------------------------------------

@dataclasses.dataclass
class IOEmbedding:
    """Input encoder + output target + loss + decoder for one method."""

    name: str
    d: int
    m_in: int
    m_out: int

    def encode_input(self, p: torch.Tensor) -> torch.Tensor:
        """(B, c_max) padded ids -> (B, m_in) dense network input."""
        raise NotImplementedError

    def loss(self, pred: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """(B, m_out) net output (pre-activation logits) + (B, c) targets
        -> (B,) losses."""
        raise NotImplementedError

    def decode(self, pred: torch.Tensor) -> torch.Tensor:
        """(B, m_out) net output -> (B, d) ranking scores (higher=better)."""
        raise NotImplementedError


def _on(x, device) -> Optional[torch.Tensor]:
    """An optional array (numpy, or anything numpy reads) or tensor as a
    tensor on ``device``."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


# --------------------------------------------------------------------------
# Bloom embeddings / hashing trick (HT == BE with k=1, paper Sec. 4.3)
# --------------------------------------------------------------------------

def eq3_scores(spec: BloomSpec, pred: torch.Tensor,
               hash_matrix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, m) logits -> (B, d) Eq. 3 scores of their log_softmax through
    ``spec`` (or the explicit (d, k) ``hash_matrix``): the ``bloom_decode``
    kernel on a CUDA tensor, ``decode_scores`` on a CPU tensor."""
    logp = torch.log_softmax(pred, dim=-1)
    if logp.is_cuda:
        return ops.bloom_decode(logp, spec, hash_matrix=hash_matrix)
    return decode_scores(spec, logp, hash_matrix)


@dataclasses.dataclass
class BloomIO(IOEmbedding):
    spec_in: BloomSpec = None
    spec_out: BloomSpec = None
    H_in: Optional[torch.Tensor] = None     # optional CBE-adjusted matrices
    H_out: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, d: int, m: int, k: int = 4, seed: int = 0,
              H_in=None, H_out=None, name: str = "BE", device=None):
        """Input spec from ``seed``, output spec from ``seed + 1``; explicit
        (d, k) matrices (CBE) replace the double hash on their side."""
        device = resolve_device(device)
        spec_i = BloomSpec(d=d, m=m, k=k, seed=seed,
                           on_the_fly=H_in is None)
        spec_o = BloomSpec(d=d, m=m, k=k, seed=seed + 1,
                           on_the_fly=H_out is None)
        return cls(name=name, d=d, m_in=m, m_out=m, spec_in=spec_i,
                   spec_out=spec_o, H_in=_on(H_in, device),
                   H_out=_on(H_out, device))

    def encode_input(self, p):
        return bloom_encode(self.spec_in, p, self.H_in)

    def loss(self, pred, q):
        return losses.bloom_xent_multilabel(self.spec_out, pred, q,
                                            self.H_out)

    def decode(self, pred):
        return eq3_scores(self.spec_out, pred, self.H_out)


def hashing_trick(d: int, m: int, seed: int = 0, device=None) -> BloomIO:
    """HT baseline = BE special case with k = 1 (Ganchev & Dredze recovery)."""
    return BloomIO.build(d=d, m=m, k=1, seed=seed, name="HT", device=device)


# --------------------------------------------------------------------------
# ECOC (Dietterich & Bakiri randomized hill-climbing codes)
# --------------------------------------------------------------------------

def _ecoc_code_matrix(d: int, m: int, seed: int, iters: int = 200,
                      sample: int = 256) -> np.ndarray:
    """Randomized hill-climbing on min pairwise Hamming distance.

    Exact all-pairs hill-climbing is O(d^2 m); we hill-climb on sampled row
    pairs, which recovers the published construction's behaviour for the
    d >> m regime (random codes are already near-optimal there).
    """
    rng = np.random.default_rng(seed)
    C = (rng.random((d, m)) < 0.5).astype(np.int8)
    for _ in range(iters):
        rows = rng.integers(0, d, size=sample)
        sub = C[rows]
        # pair with the nearest sampled row, then flip the bit that helps.
        dist = (sub[:, None, :] ^ sub[None, :, :]).sum(-1)
        np.fill_diagonal(dist, m + 1)
        nearest = dist.argmin(1)
        for i, j in enumerate(nearest):
            if dist[i, j] > m // 2:
                continue
            agree = np.nonzero(sub[i] == sub[j])[0]
            if agree.size:
                b = rng.choice(agree)
                C[rows[i], b] ^= 1
    return C


def _embed_sets(table: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sum of ``table``'s rows over each padded id set: (B, c) -> (B, r);
    -1 pads add nothing."""
    valid = (p >= 0)[..., None].to(table.dtype)
    rows = table[p.clamp_min(0).long()]                       # (B, c, r)
    return (rows * valid).sum(-2)


def _cosine_scores(pred: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(B, r) x (d, r) -> (B, d) cosine similarities (KNN decode)."""
    vn = vecs / (torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
                 + 1e-8)
    pn = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
                 + 1e-8)
    return pn @ vn.T


@dataclasses.dataclass
class ECOCIO(IOEmbedding):
    code: torch.Tensor = None          # (d, m) binary codes, float32

    @classmethod
    def build(cls, d: int, m: int, seed: int = 0, iters: int = 200,
              device=None):
        C = _ecoc_code_matrix(d, m, seed, iters)
        return cls(name="ECOC", d=d, m_in=m, m_out=m,
                   code=torch.as_tensor(C, dtype=torch.float32).to(
                       resolve_device(device)))

    def _encode(self, p):
        return torch.clamp_max(_embed_sets(self.code, p), 1.0)

    def encode_input(self, p):
        return self._encode(p)

    def loss(self, pred, q):
        # Paper Sec. 4.3: Hamming loss underperformed; use CE on normalized
        # code-union target, same as BE's multilabel CE.
        u = self._encode(q)
        mass = torch.clamp(u.sum(-1, keepdim=True), min=1e-9)
        return losses.softmax_xent_dense(pred, u / mass)

    def decode(self, pred):
        logp = torch.log_softmax(pred, dim=-1)
        w = self.code / torch.clamp(self.code.sum(-1, keepdim=True), min=1.0)
        return logp @ w.T                                   # (B, d)


# --------------------------------------------------------------------------
# PMI (Chollet 2016: SVD of the pointwise-mutual-information matrix + KNN)
# --------------------------------------------------------------------------

def _pmi_vectors(X: sp.spmatrix, r: int, seed: int = 0) -> np.ndarray:
    X = X.tocsr().astype(np.float64)
    n, d = X.shape
    C = (X.T @ X).toarray()
    freq = np.asarray(X.sum(0)).ravel() + 1e-9
    pmi = np.log((C * n + 1e-9) / np.outer(freq, freq))
    pmi = np.maximum(pmi, 0.0)       # positive PMI, standard practice
    r = min(r, d - 1)
    u, s, _ = spla.svds(sp.csr_matrix(pmi), k=r,
                        random_state=np.random.default_rng(seed))
    order = np.argsort(-s)
    return (u[:, order] * np.sqrt(s[order])).astype(np.float32)


@dataclasses.dataclass
class PMIIO(IOEmbedding):
    vecs: torch.Tensor = None          # (d, r) item vectors

    @classmethod
    def build(cls, X: sp.spmatrix, m: int, seed: int = 0, device=None):
        d = X.shape[1]
        V = _pmi_vectors(X, m, seed)
        return cls(name="PMI", d=d, m_in=V.shape[1], m_out=V.shape[1],
                   vecs=torch.from_numpy(V).to(resolve_device(device)))

    def encode_input(self, p):
        return _embed_sets(self.vecs, p)

    def loss(self, pred, q):
        return losses.cosine_proximity_loss(pred, _embed_sets(self.vecs, q))

    def decode(self, pred):
        return _cosine_scores(pred, self.vecs)


# --------------------------------------------------------------------------
# CCA (Hotelling; SVD of the input/output cross-correlation + KNN)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CCAIO(IOEmbedding):
    U: torch.Tensor = None             # (d, r) input projections
    V: torch.Tensor = None             # (d, r) output projections

    @classmethod
    def build(cls, X_in: sp.spmatrix, X_out: sp.spmatrix, m: int,
              seed: int = 0, device=None):
        Xi = X_in.tocsr().astype(np.float64)
        Xo = X_out.tocsr().astype(np.float64)
        d = Xi.shape[1]
        # whitened cross-correlation (spectral CCA, Hsu et al. 2012 style)
        fi = np.asarray(Xi.sum(0)).ravel() + 1.0
        fo = np.asarray(Xo.sum(0)).ravel() + 1.0
        Cxy = (Xi.T @ Xo).toarray() / np.sqrt(np.outer(fi, fo))
        r = min(m, d - 1)
        u, s, vt = spla.svds(sp.csr_matrix(Cxy), k=r,
                             random_state=np.random.default_rng(seed))
        order = np.argsort(-s)
        U = (u[:, order] * np.sqrt(s[order])).astype(np.float32)
        V = (vt[order].T * np.sqrt(s[order])).astype(np.float32)
        device = resolve_device(device)
        return cls(name="CCA", d=d, m_in=r, m_out=r,
                   U=torch.from_numpy(U).to(device),
                   V=torch.from_numpy(np.ascontiguousarray(V)).to(device))

    def encode_input(self, p):
        return _embed_sets(self.U, p)

    def loss(self, pred, q):
        return losses.cosine_proximity_loss(pred, _embed_sets(self.V, q))

    def decode(self, pred):
        return _cosine_scores(pred, self.V)
