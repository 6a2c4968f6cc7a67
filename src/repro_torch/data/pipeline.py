"""Resumable, shard-aware batch pipeline (numpy; copied from the JAX
package's ``data/pipeline.py``).

Deterministic iteration whose full state (epoch, cursor, shuffle seed) is a
small dict stored inside every checkpoint — resuming after preemption
replays from the exact batch boundary (fault-tolerance requirement,
DESIGN.md §6).  Host-sharding: each host takes a strided slice
(host_id::host_count) so multi-host data-parallel feeding needs no
coordination.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class BatchIterator:
    """Shuffled, epoch-aware iterator over aligned numpy arrays."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 seed: int = 0, host_id: int = 0, host_count: int = 1,
                 drop_remainder: bool = True):
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("arrays must share their leading dimension")
        self.arrays = [a[host_id::host_count] for a in arrays]
        self.n = self.arrays[0].shape[0]
        self.batch_size = batch_size
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0
        self.cursor = 0
        self._perm = self._make_perm()

    def _make_perm(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(self.n)

    # ---- checkpointable state ------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor,
                "seed": self.seed}

    def restore(self, state: Dict[str, int]):
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self._perm = self._make_perm()

    # ---- iteration ------------------------------------------------------
    def __next__(self):
        if self.cursor + self.batch_size > self.n:
            if self.drop_remainder or self.cursor >= self.n:
                self.epoch += 1
                self.cursor = 0
                self._perm = self._make_perm()
        idx = self._perm[self.cursor:self.cursor + self.batch_size]
        self.cursor += self.batch_size
        return tuple(a[idx] for a in self.arrays)

    def __iter__(self):
        return self

    def batches_per_epoch(self) -> int:
        return self.n // self.batch_size


def lm_batches(stream: np.ndarray, batch: int, seq_len: int):
    """Chop a token stream into (batch, seq_len+1) windows (inputs+shifted
    labels come from the same window)."""
    per = seq_len + 1
    n_windows = len(stream) // per
    windows = stream[:n_windows * per].reshape(n_windows, per)
    return windows
