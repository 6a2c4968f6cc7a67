"""Evaluation measures used by the paper (Sec. 4.1): MAP, RR, Accuracy."""
from __future__ import annotations

import numpy as np


def average_precision(scores: np.ndarray, relevant: np.ndarray,
                      exclude: np.ndarray | None = None) -> float:
    """AP of `relevant` item ids under `scores` (d,), optionally excluding
    `exclude` ids (e.g. the user's input items) from the ranking."""
    s = np.asarray(scores, np.float64).copy()
    rel = set(int(i) for i in relevant if i >= 0)
    if not rel:
        return np.nan
    if exclude is not None:
        ex = [int(i) for i in exclude if i >= 0 and int(i) not in rel]
        s[ex] = -np.inf
    # stable sort: ties rank in ascending item-id order — the SAME
    # tie-break every top-k decode path follows (DESIGN.md §11), and
    # deterministic (the default introsort permutes ties arbitrarily,
    # which made MAP on tied scores platform-dependent)
    order = np.argsort(-s, kind="stable")
    hits, ap = 0, 0.0
    for rank, item in enumerate(order, start=1):
        if int(item) in rel:
            hits += 1
            ap += hits / rank
            if hits == len(rel):
                break
    return ap / len(rel)


def mean_average_precision(scores: np.ndarray, relevants: np.ndarray,
                           excludes: np.ndarray | None = None) -> float:
    """MAP over a batch. scores (B, d); relevants (B, c) -1-padded."""
    aps = []
    for i in range(scores.shape[0]):
        ex = None if excludes is None else excludes[i]
        ap = average_precision(scores[i], relevants[i], ex)
        if not np.isnan(ap):
            aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def reciprocal_rank(scores: np.ndarray, target: np.ndarray,
                    exclude: np.ndarray | None = None) -> float:
    """Mean RR of the single correct item. scores (B, d), target (B,).

    Tie handling is mid-rank: ``rank = greater + ties/2 + 1`` where
    ``ties`` counts the OTHER items scoring exactly scores[t].  The old
    ``greater + 1`` rank was optimistic — an untrained model emitting
    constant scores got RR = 1.0 for every target; mid-rank gives the
    honest expectation over random tie orders (RR ~ 2/d for d-way ties).

    ``exclude`` (B, c) -1-padded masks e.g. the user's input items from
    the ranking, mirroring average_precision.
    """
    scores = np.asarray(scores, np.float64)
    rrs = []
    for i in range(scores.shape[0]):
        t = int(target[i])
        if t < 0:
            continue
        s = scores[i]
        if exclude is not None:
            s = s.copy()
            ex = [int(j) for j in exclude[i] if j >= 0 and int(j) != t]
            s[ex] = -np.inf
        greater = int((s > s[t]).sum())
        ties = int((s == s[t]).sum()) - 1   # items tied with the target
        rrs.append(1.0 / (greater + ties / 2.0 + 1.0))
    return float(np.mean(rrs)) if rrs else 0.0


def accuracy(scores: np.ndarray, target: np.ndarray,
             exclude: np.ndarray | None = None) -> float:
    """Top-1 accuracy (%) of the single correct item. scores (B, d),
    target (B,) with -1 = skip the row.

    ``exclude`` (B, c) -1-padded masks e.g. the user's input items from
    the ranking before the argmax, mirroring average_precision /
    reciprocal_rank — the paper's Sec. 4.1 accuracy on retrieval evals
    must not rank items the user already has (the target itself is never
    masked).  Tied argmax resolves to the LOWEST item id (np.argmax
    returns the first maximum) — the same tie-break contract every
    top-k decode path follows (DESIGN.md §11).
    """
    scores = np.asarray(scores, np.float64)
    if exclude is not None:
        scores = scores.copy()
        for i in range(scores.shape[0]):
            t = int(target[i])
            ex = [int(j) for j in exclude[i] if j >= 0 and int(j) != t]
            scores[i, ex] = -np.inf
    pred = scores.argmax(-1)
    valid = target >= 0
    if valid.sum() == 0:
        return 0.0
    return float((pred[valid] == target[valid]).mean() * 100.0)
