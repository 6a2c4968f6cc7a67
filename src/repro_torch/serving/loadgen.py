"""Deterministic seeded load generator for the serving engine.

Arrivals are Poisson in *decode-step time* (exponential inter-arrival
gaps at `rate` requests/step, floored onto the integer step clock) with a
categorical prompt/generation length mix — the mixed-length workload that
makes static batching burn slot-steps on drained requests (DLRM-style
serving traffic, cf. Naumov et al., 2019).  Everything is a pure function
of `seed`, so the simulation tests and the committed BENCH_serving.json
baseline replay the exact same trace on every CI run.  Under sharding the
same contract holds per host: ``host_stream`` is a pure function of
``(seed, host_id)``, so the multi-host schedule replays exactly no matter
which hosts draw first (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    n_requests: int = 16
    vocab: int = 1024
    rate: float = 0.5                    # mean arrivals per decode step
    prompt_lens: Tuple[int, ...] = (8, 16, 24)
    gen_lens: Tuple[int, ...] = (4, 8, 24)
    gen_weights: Tuple[float, ...] = ()  # uniform when empty
    seed: int = 0

    def __post_init__(self):
        # rate=0 used to surface as a ZeroDivisionError deep inside
        # _draw_stream's exponential draw; a weights/lens length mismatch
        # as an opaque numpy error inside rng.choice — validate both at
        # construction with messages that name the fields
        if not self.rate > 0:
            raise ValueError(
                f"LoadSpec.rate must be > 0 arrivals/step (got "
                f"{self.rate}); the arrival process draws exponential "
                "gaps at 1/rate")
        if self.gen_weights and len(self.gen_weights) != len(self.gen_lens):
            raise ValueError(
                f"LoadSpec.gen_weights has {len(self.gen_weights)} "
                f"entries for {len(self.gen_lens)} gen_lens; the "
                "categorical mix needs one weight per length (or an "
                "empty tuple for uniform)")


def _draw_stream(rng: np.random.Generator, spec: LoadSpec,
                 rid_of, home: int) -> list[Request]:
    """One seeded arrival stream — the single sampling implementation
    behind make_workload AND host_stream, so the mixes can never diverge
    (merge_workloads must replay the identical traffic through the
    single-host engine).  Draw order (gaps, prompt lens, gen lens,
    prompts) is part of the committed-bench contract — do not reorder."""
    gaps = rng.exponential(1.0 / spec.rate, size=spec.n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    p_lens = rng.choice(spec.prompt_lens, size=spec.n_requests)
    w = (np.asarray(spec.gen_weights, np.float64)
         if spec.gen_weights else None)
    if w is not None:
        w = w / w.sum()
    g_lens = rng.choice(spec.gen_lens, size=spec.n_requests, p=w)
    reqs = []
    for i in range(spec.n_requests):
        prompt = rng.integers(0, spec.vocab, size=int(p_lens[i]),
                              dtype=np.int32)
        reqs.append(Request(rid=rid_of(i), prompt=prompt,
                            max_gen=int(g_lens[i]),
                            arrival_step=int(arrivals[i]), home=home))
    return reqs


def make_workload(spec: LoadSpec) -> list[Request]:
    """spec -> arrival-ordered [Request] (prompts drawn uniform over vocab)."""
    return _draw_stream(np.random.default_rng(spec.seed), spec,
                        rid_of=lambda i: i, home=0)


def host_stream(spec: LoadSpec, host: int, n_hosts: int) -> list[Request]:
    """One host's arrival stream for the sharded engine: a pure function
    of ``(spec.seed, host)`` and NOTHING else — in particular not of how
    many streams were drawn before it, so any subset of hosts replays
    bit-identically and the multi-host schedule is exactly reproducible
    (DESIGN.md §8; regression-tested in tests/test_serving_multihost.py).

    ``np.random.default_rng([seed, host])`` seeds the underlying
    SeedSequence with the (seed, host) entropy pair — independent per-host
    streams without any shared-counter coupling.  rids are globally unique
    and host-tagged: ``rid = i * n_hosts + host``.
    """
    return _draw_stream(np.random.default_rng([spec.seed, host]), spec,
                        rid_of=lambda i: i * n_hosts + host, home=host)


def sharded_workload(spec: LoadSpec, n_hosts: int) -> list[list[Request]]:
    """Per-host arrival streams (``spec.n_requests`` requests EACH);
    ``[h]`` is host h's stream.  See host_stream for the determinism
    contract."""
    return [host_stream(spec, h, n_hosts) for h in range(n_hosts)]


def merge_workloads(per_host: list[list[Request]]) -> list[Request]:
    """Flatten per-host streams into one global arrival-ordered workload
    (ties broken by (home, rid) — the same order the gossiped queue uses),
    for replaying the identical traffic through a single-host engine."""
    return sorted((r for reqs in per_host for r in reqs),
                  key=lambda r: (r.arrival_step, r.home, r.rid))


def burst_workload(spec: LoadSpec, step: int = 0) -> list[Request]:
    """A whole workload arriving at the SAME step — the prefill-pool
    stress shape (DESIGN.md §9): one prefill worker serializes the burst
    and head-of-line blocks admission; a pool of N drains it ~N-times
    faster in prefill-time while the step-clock schedule (and every
    recovered token) is unchanged.  Prompt/generation mixes draw exactly
    like ``make_workload`` (same seeded stream), only the arrival steps
    are collapsed onto ``step``.

    Fresh instances on purpose: the old in-place ``r.arrival_step =
    step`` mutated the very Requests make_workload returned, and Request
    also carries engine-filled bookkeeping (tokens, admitted_step, ...)
    that must start virgin — replaying one workload list through two
    engines would silently leak the first run's state into the second
    (fresh_copy resets nothing because there is nothing to reset)."""
    return [r.fresh_copy(arrival_step=step) for r in make_workload(spec)]


def assert_fresh_instances(*workloads) -> None:
    """Guard for A/B drivers: workload lists replayed through different
    engines must not share Request instances (engine-filled bookkeeping
    would leak between runs) and every request must still be virgin — no
    tokens, no admission — i.e. built by loadgen / ``fresh_copy``, not
    recycled from a previous run."""
    seen: set = set()
    for wl in workloads:
        for r in wl:
            if id(r) in seen:
                raise AssertionError(
                    f"request rid={r.rid} is the SAME instance in two "
                    "workload replays — engine-filled state would leak "
                    "between runs; build each replay via fresh_copy()")
            seen.add(id(r))
            if r.tokens or r.topk_ids or r.admitted_step >= 0 \
                    or r.finish_step >= 0 or r.slot >= 0:
                raise AssertionError(
                    f"request rid={r.rid} carries engine-filled state "
                    "(already served?) — replay fresh_copy()s, not the "
                    "previous run's objects")


def overload_workload(spec: LoadSpec, n_hosts: int, *, surge_start: int,
                      surge_factor: int,
                      deadline_slack: int | None = None
                      ) -> list[list[Request]]:
    """Open-loop overload traffic (DESIGN.md §14): each host's seeded
    Poisson stream (``host_stream`` — still pure in (seed, host)), with
    arrivals at or after ``surge_start`` compressed toward it by
    ``surge_factor`` (``a -> start + (a - start) // factor`` — the SAME
    transform ``FailPlan`` ``surge:R@S`` applies at injection time, here
    baked into ``arrival_step`` itself) and, with ``deadline_slack``
    set, an SLO deadline of ``arrival_step + deadline_slack`` per
    request.  Benches and drills use this instead of hand-rolling surge
    schedules; a failpoint surge composes on top (it re-compresses the
    already-compressed steps).

    Validated like ``LoadSpec``: a bad knob fails loudly at the call,
    not as a silent never-shedding or always-shedding run."""
    if surge_start < 0:
        raise ValueError(
            f"surge_start must be >= 0 (got {surge_start}); it is the "
            "first compressed arrival step")
    if surge_factor < 2:
        raise ValueError(
            f"surge_factor must be >= 2 (got {surge_factor}); factor 1 "
            "would be a no-op surge — drop the parameter instead")
    if deadline_slack is not None and deadline_slack < 1:
        raise ValueError(
            f"deadline_slack must be >= 1 step (got {deadline_slack}); "
            "a zero slack sheds every request that misses same-step "
            "admission")
    out = []
    for h in range(n_hosts):
        reqs = host_stream(spec, h, n_hosts)
        for r in reqs:
            if r.arrival_step >= surge_start:
                r.arrival_step = (surge_start
                                  + (r.arrival_step - surge_start)
                                  // surge_factor)
            if deadline_slack is not None:
                r.deadline_step = r.arrival_step + deadline_slack
        out.append(reqs)
    return out


def mixed_length_workload(vocab: int, n_requests: int = 12,
                          seed: int = 0) -> list[Request]:
    """The canonical bench/test workload: bursty arrivals, bimodal
    generation lengths (many short, few long) — the shape where
    continuous batching beats static by the largest factor."""
    return make_workload(LoadSpec(
        n_requests=n_requests, vocab=vocab, rate=2.0,
        prompt_lens=(6, 10, 14), gen_lens=(3, 6, 20),
        gen_weights=(0.5, 0.3, 0.2), seed=seed))


# ---------------------------------------------------------------------------
# Retrieval traffic (DESIGN.md §11): Zipf-skewed one-shot item lookups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetrievalLoadSpec:
    """Web-scale retrieval traffic over a d-item catalog: each request
    carries a padded set of input item ids (the user's history, Bloom-
    encoded on admit) plus held-out target items for offline ranking
    eval.  Item popularity is Zipf(1)-skewed — the DLRM traffic shape
    (Naumov et al., 2019): a few head items dominate, the tail is huge."""

    n_requests: int = 16
    catalog: int = 1 << 20               # d — item-catalog size
    c_max: int = 8                       # input items per request
    n_targets: int = 2                   # held-out eval items per request
    rate: float = 2.0                    # mean arrivals per decode step
    seed: int = 0

    def __post_init__(self):
        if not self.rate > 0:
            raise ValueError(
                f"RetrievalLoadSpec.rate must be > 0 (got {self.rate})")
        if self.c_max < 1 or self.n_targets < 0:
            raise ValueError(
                f"need c_max >= 1 and n_targets >= 0, got c_max="
                f"{self.c_max} n_targets={self.n_targets}")
        if self.catalog < 4 * (self.c_max + self.n_targets):
            raise ValueError(
                f"catalog {self.catalog} too small to draw "
                f"{self.c_max + self.n_targets} distinct items per "
                "request with a skewed popularity law")


def _zipf_items(rng: np.random.Generator, catalog: int,
                size: int) -> np.ndarray:
    """Zipf(s=1)-skewed item draws over [0, catalog), head at id 0.

    Inverse-CDF of the log-uniform density (pdf ∝ 1/(x+1)): item i draws
    with probability ∝ ln((i+2)/(i+1)) ≈ 1/(i+1) — the bounded Zipf(1)
    law — in O(size) numpy work with NO d-length probability vector, so
    the generator stays cheap at 10M-item catalogs."""
    u = rng.random(size)
    return np.floor(np.exp(u * np.log(float(catalog) + 1.0))
                    ).astype(np.int64) - 1


def retrieval_workload(spec: RetrievalLoadSpec, host: int = 0,
                       n_hosts: int = 1) -> list[Request]:
    """One host's Zipf-skewed retrieval stream — the same pure-function-
    of ``(seed, host)`` contract as ``host_stream`` (DESIGN.md §8/§11):
    independent per-host rngs via the (seed, host) entropy pair, rids
    globally unique and host-tagged (``i * n_hosts + host``), so any
    subset of hosts replays bit-identically.

    Every request is ``kind="oneshot"``: prompt = ``c_max`` distinct
    item ids (popularity-skewed, deduped in first-draw order), max_gen=1
    (prefill -> one recover step -> retire), targets = ``n_targets``
    further distinct held-out items for offline MAP/RR eval.  Draw order
    (gaps, then per-request item sets) is part of the committed-bench
    contract — do not reorder."""
    rng = np.random.default_rng([spec.seed, host])
    n, want = spec.n_requests, spec.c_max + spec.n_targets
    gaps = rng.exponential(1.0 / spec.rate, size=n)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    reqs = []
    for i in range(n):
        draw = _zipf_items(rng, spec.catalog, size=4 * want + 16)
        items = list(dict.fromkeys(draw.tolist()))[:want]
        while len(items) < want:          # head-heavy small catalogs can
            extra = rng.integers(0, spec.catalog, size=want)  # collide out
            items.extend(v for v in dict.fromkeys(extra.tolist())
                         if v not in set(items))
            items = items[:want]
        items_arr = np.asarray(items, np.int32)
        reqs.append(Request(
            rid=i * n_hosts + host,
            prompt=items_arr[:spec.c_max],
            max_gen=1, arrival_step=int(arrivals[i]), home=host,
            kind="oneshot", targets=items_arr[spec.c_max:]))
    return reqs


def arrival_span(per_host: list[list[Request]]) -> tuple[int, int]:
    """(first, last) arrival step across per-host streams.  The chaos
    paths (sim_multihost, bench_serving) use it to place a host kill
    mid-traffic — strictly after the first arrival, before the last —
    so the kill is guaranteed to find in-flight work for ANY seed."""
    arrivals = [r.arrival_step for reqs in per_host for r in reqs]
    if not arrivals:
        return (0, 0)
    return (min(arrivals), max(arrivals))
