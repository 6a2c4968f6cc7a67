"""Synthetic data generators.

Copied from the JAX package's ``data/synthetic.py``: ``make_token_stream``
(numpy, element for element the reference's).  The recommender datasets
wait for ROADMAP A6/A11.
"""
from __future__ import annotations

import numpy as np


def make_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                      zipf_a: float = 1.1) -> np.ndarray:
    """Zipf token stream for LM smoke training (qwen-style cells)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.power(np.arange(1, vocab + 1), zipf_a)
    p /= p.sum()
    return rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
