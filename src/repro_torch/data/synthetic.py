"""Synthetic data generators matched to the paper's dataset statistics.

Copied from the JAX package's ``data/synthetic.py`` (numpy and scipy, so
the output equals the reference's element for element, sparse matrices
included).  The paper's 7 datasets are public but not in the repository;
these generators dial latent-factor interaction data to each task's
*statistics* (dimensionality d, median set size c, density c/d,
co-occurrence structure: paper Tables 1 & 4), so the paper's benches
(``benchmarks/``) run end to end.  ``make_token_stream`` feeds the LM's
smoke training.

Generator: users/items live in a low-rank latent space with Zipf-distributed
item popularity; a user's profile is sampled from popularity x affinity and
split at a random point into input/output halves — the paper's
'split user profiles at a timestamp chosen uniformly at random'.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class RecsysData:
    """Padded index-set views (+ sparse matrices) of a generated dataset."""

    d: int
    p_in: np.ndarray          # (n, c_max) int32, -1 padded — input item sets
    q_out: np.ndarray         # (n, c_max) int32, -1 padded — target sets
    X_in: sp.csr_matrix       # (n, d) binary
    X_out: sp.csr_matrix
    n_train: int

    @property
    def n(self) -> int:
        return self.p_in.shape[0]

    def train(self):
        return self.p_in[:self.n_train], self.q_out[:self.n_train]

    def test(self):
        return self.p_in[self.n_train:], self.q_out[self.n_train:]


def _pad_sets(sets, c_max: int) -> np.ndarray:
    out = np.full((len(sets), c_max), -1, np.int32)
    for i, s in enumerate(sets):
        s = np.asarray(s[:c_max], np.int32)
        out[i, :len(s)] = s
    return out


def _to_sparse(sets, n: int, d: int) -> sp.csr_matrix:
    rows, cols = [], []
    for i, s in enumerate(sets):
        rows.extend([i] * len(s))
        cols.extend(s)
    data = np.ones(len(rows), np.float64)
    return sp.csr_matrix((data, (rows, cols)), shape=(n, d))


def make_recsys(
    n: int = 4000,
    d: int = 2000,
    rank: int = 16,
    mean_items: int = 12,
    zipf_a: float = 1.2,
    test_frac: float = 0.2,
    seed: int = 0,
) -> RecsysData:
    """Latent-factor interaction data with Zipf popularity."""
    rng = np.random.default_rng(seed)
    users = rng.normal(size=(n, rank)) / np.sqrt(rank)
    items = rng.normal(size=(d, rank)) / np.sqrt(rank)
    pop = 1.0 / np.power(np.arange(1, d + 1), zipf_a)
    pop = pop[rng.permutation(d)]
    pop /= pop.sum()

    p_in_sets, q_out_sets = [], []
    logits_scale = 4.0
    for u in range(n):
        c = max(2, int(rng.poisson(mean_items)))
        aff = users[u] @ items.T
        w = pop * np.exp(logits_scale * aff)
        w /= w.sum()
        profile = rng.choice(d, size=min(c, d), replace=False, p=w)
        split = rng.integers(1, len(profile)) if len(profile) > 1 else 1
        p_in_sets.append(profile[:split])
        q_out_sets.append(profile[split:] if split < len(profile)
                          else profile[-1:])

    c_max = max(max(len(s) for s in p_in_sets),
                max(len(s) for s in q_out_sets))
    n_train = int(n * (1 - test_frac))
    return RecsysData(
        d=d,
        p_in=_pad_sets(p_in_sets, c_max),
        q_out=_pad_sets(q_out_sets, c_max),
        X_in=_to_sparse(p_in_sets, n, d),
        X_out=_to_sparse(q_out_sets, n, d),
        n_train=n_train,
    )


def make_classification(
    n: int = 3000,
    d: int = 5000,
    n_classes: int = 12,
    mean_items: int = 17,
    seed: int = 0,
    test_frac: float = 0.25,
):
    """CADE-style: sparse binary documents -> one of n_classes labels.

    Class-conditional Zipf vocabularies with overlap, mirroring text
    categorization.  Returns (p_in (n,c_max), labels (n,), n_train).
    """
    rng = np.random.default_rng(seed)
    class_centers = rng.dirichlet(np.full(d, 0.05), size=n_classes)
    labels = rng.integers(0, n_classes, size=n)
    sets = []
    for i in range(n):
        c = max(3, int(rng.poisson(mean_items)))
        sets.append(rng.choice(d, size=min(c, d), replace=False,
                               p=class_centers[labels[i]]))
    c_max = max(len(s) for s in sets)
    n_train = int(n * (1 - test_frac))
    return (_pad_sets(sets, c_max), labels.astype(np.int32), n_train,
            _to_sparse(sets, n, d))


def make_sessions(
    n_sessions: int = 6000,
    d: int = 3000,
    mean_len: int = 6,
    rank: int = 12,
    seed: int = 0,
    test_frac: float = 0.2,
):
    """YC/PTB-style next-item sequences from a latent Markov process.

    Returns (seqs (n, T_max) int32 -1-padded, n_train).  Targets are the
    next element at every position.
    """
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(d, rank)) / np.sqrt(rank)
    pop = 1.0 / np.power(np.arange(1, d + 1), 1.1)
    pop = pop[rng.permutation(d)] / pop.sum()
    seqs = []
    for s in range(n_sessions):
        T = max(2, int(rng.poisson(mean_len)))
        cur = rng.choice(d, p=pop)
        seq = [cur]
        for _ in range(T - 1):
            aff = items[cur] @ items.T
            w = pop * np.exp(5.0 * aff)
            w /= w.sum()
            cur = rng.choice(d, p=w)
            seq.append(cur)
        seqs.append(seq)
    t_max = max(len(s) for s in seqs)
    padded = _pad_sets(seqs, t_max)
    return padded, int(n_sessions * (1 - test_frac))


def make_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                      zipf_a: float = 1.1) -> np.ndarray:
    """Zipf token stream for LM smoke training (qwen-style cells)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.power(np.arange(1, vocab + 1), zipf_a)
    p /= p.sum()
    return rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
