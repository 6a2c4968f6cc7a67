"""Deadline-aware admission control, backpressure and graceful
degradation (DESIGN.md §14).

Overload is the failure mode the fault model left unmodeled: the queue
was unbounded, requests had no deadlines, and a sustained arrival rate
above pool throughput just grew ``pending`` forever.  This module is the
policy layer that closes that hole, built on the same discipline as
compaction planning (control.plan_compaction): every decision here is a
**pure function of replicated state** — queue contents, deadlines,
occupancy, the clock — so every host computes the identical shed set and
the identical degrade stage at the identical step WITHOUT transporting
either.  SHED and DEGRADE/RESTORE are logged for exact replay, never
gossiped; only arrivals/releases/host-downs ever travel.

Three mechanisms, in the order the scheduler applies them each step:

  * **Deadline shedding** — a queued request whose ``deadline_step`` has
    passed (now > deadline) can no longer meet its SLO, so it is shed
    rather than admitted late.  Admitted requests are never shed: work
    already holding a slot always runs to completion (a reclaimed rid
    re-queued by HOST_DOWN becomes sheddable again, deliberately — its
    deadline did not die with the host).
  * **Bounded queues (backpressure)** — with ``max_queue_depth`` set,
    each home keeps only the FIFO-first ``max_queue_depth`` of its
    visible queued requests; the excess (latest arrivals first) is shed.
    This is load shedding at the door: the replicated queue can no
    longer grow without bound under a surge.
  * **Graceful degradation** — ``pressure`` (visible queue depth over
    live slot capacity) is averaged over a sliding window; the windowed
    signal drives a staged ladder executed identically by every replica:
    stage 1 halves the served top-k width, stage 2 shrinks it to
    ``degraded_topk`` (see the stage constants below for why the ladder
    narrows top-k rather than swapping to int8 tables).  Stages move one
    step per
    clock tick (DEGRADE up, RESTORE down, with hysteresis so the ladder
    cannot flap), and every stage's decode callable is pre-built at
    engine construction — a transition swaps jits, it NEVER compiles
    (the compaction zero-recompile trick, asserted in the drills).

Like control.py, this module is deliberately JAX-free (pure python) so
the hypothesis suite can sweep thousands of random (topology, surge,
deadline) combinations against the policy in microseconds, and the
signatures take plain mappings rather than ``ControlState`` so the
single-host engine loop (engine.run_slot_loop) and the sharded control
plane share one implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

# Shed reasons (logged in the event's reason field)
SHED_DEADLINE = 0       # deadline passed while queued
SHED_QUEUE_FULL = 1     # per-host queue bound exceeded (backpressure)

# Degrade ladder stages.  Both degraded stages narrow the SERVED top-k
# width (pre-built decode jits at smaller k): the fused decode-topk's
# k-selection work and the per-step d2h payload shrink, while the
# emitted results stay a bit-identical prefix of the unloaded run's
# (the pinned lowest-id tie-break makes top-k at k' < k a prefix of
# top-k at k; the LM's next token is the top-1 id, so it is invariant).
# The int8 ``table_dtype`` path was measured and REJECTED as a ladder
# stage: per-row fake-quant flips the greedy argmax (8/48 top-1 flips
# on the smoke model), which would break the serving contract that a
# completed request is bit-identical to its unloaded twin — int8 stays
# a construction-time choice (DESIGN.md §13), not a mid-run swap.
STAGE_NORMAL = 0        # full top-k
STAGE_NARROW = 1        # served top-k halved
STAGE_MIN = 2           # served top-k shrunk to policy.degraded_topk
MAX_STAGE = STAGE_MIN


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The overload policy knobs — immutable pure data, validated like
    LoadSpec so a bad config fails at construction, not mid-drill.

    ``max_queue_depth`` bounds each home's *visible* queued requests
    (None = unbounded, the pre-PR-10 behaviour).  The pressure ladder
    degrades at windowed-average pressure >= ``degrade_lo`` (stage 1)
    / ``degrade_hi`` (stage 2) and restores a stage only once the
    average falls to ``restore_below`` — the hysteresis gap keeps a
    near-threshold signal from flapping the jit swap every step.
    ``max_stage`` caps the ladder (0 disables degradation entirely;
    shedding still applies)."""

    max_queue_depth: Optional[int] = None
    pressure_window: int = 4
    degrade_lo: float = 1.0
    degrade_hi: float = 2.0
    restore_below: float = 0.5
    max_stage: int = MAX_STAGE
    degraded_topk: int = 1     # served top-k width at STAGE_MIN

    def __post_init__(self):
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.pressure_window < 1:
            raise ValueError(
                f"pressure_window must be >= 1, got {self.pressure_window}")
        if not (0.0 < self.degrade_lo <= self.degrade_hi):
            raise ValueError(
                "need 0 < degrade_lo <= degrade_hi, got "
                f"{self.degrade_lo} / {self.degrade_hi}")
        if not (0.0 <= self.restore_below <= self.degrade_lo):
            raise ValueError(
                "need 0 <= restore_below <= degrade_lo, got "
                f"{self.restore_below}")
        if not (0 <= self.max_stage <= MAX_STAGE):
            raise ValueError(f"max_stage must be in [0, {MAX_STAGE}], "
                             f"got {self.max_stage}")
        if self.degraded_topk < 1:
            raise ValueError(
                f"degraded_topk must be >= 1, got {self.degraded_topk}")


def compute_sheds(pending: Mapping[int, Tuple[int, int]],
                  deadlines: Mapping[int, int], now: int,
                  policy: AdmissionPolicy) -> List[Tuple[int, int]]:
    """The deterministic shed function: which queued rids drop this step,
    and why.  Pure in (pending, deadlines, now, policy) — every replica
    evaluates it on identical replicated state, so the shed set needs no
    transport (module docstring).

    ``pending`` maps rid -> (arrival_step, home) (the control plane's
    visible queue); ``deadlines`` maps rid -> deadline_step for rids
    that have one.  Returns ``[(rid, reason), ...]`` sorted by rid.
    Deadline sheds are decided first; the queue bound then applies to
    the survivors (FIFO-first ``max_queue_depth`` kept per home, excess
    shed — latest (arrival_step, rid) first)."""
    sheds: Dict[int, int] = {}
    for rid in pending:
        dl = deadlines.get(rid, -1)
        if dl >= 0 and now > dl:
            sheds[rid] = SHED_DEADLINE
    if policy.max_queue_depth is not None:
        by_home: Dict[int, List[Tuple[int, int]]] = {}
        for rid, (arrival, home) in pending.items():
            if rid not in sheds:
                by_home.setdefault(home, []).append((arrival, rid))
        for home, queued in by_home.items():
            queued.sort()
            for _, rid in queued[policy.max_queue_depth:]:
                sheds[rid] = SHED_QUEUE_FULL
    return sorted(sheds.items())


def stage_topk(topk: int, stage: int, policy: AdmissionPolicy) -> int:
    """Served top-k width at a degrade stage — THE width contract the
    engines pre-build their per-stage decode jits against (one
    definition, so the LM pool, the sharded pool and the retrieval
    program can never disagree on what a stage serves).  Narrowing is
    emission-preserving under the pinned lowest-id tie-break: the
    stage-s result is a bit-identical prefix of the stage-0 result."""
    if stage == STAGE_NORMAL:
        return topk
    if stage == STAGE_NARROW:
        return max(topk // 2, 1)
    if stage == STAGE_MIN:
        return min(policy.degraded_topk, topk)
    raise ValueError(f"unknown degrade stage {stage}")


def pressure(n_queued: int, n_live_slots: int) -> float:
    """The instantaneous pressure signal: visible queue depth over live
    slot capacity.  1.0 means a full pool's worth of work is waiting;
    a healthy pool with an empty queue reads 0.0 regardless of
    occupancy (occupied slots are work in progress, not backlog)."""
    return n_queued / max(n_live_slots, 1)


def plan_stage(window: Sequence[float], policy: AdmissionPolicy,
               stage: int) -> int:
    """Windowed pressure -> next degrade stage.  Pure: every replica
    appends the identical per-step pressure to its local window mirror
    (derived state, like the compaction plan — never transported) and
    steps the ladder identically.

    The ladder moves at most ONE stage per tick: escalation when the
    window average crosses the stage's threshold, restoration only once
    it falls to ``restore_below`` (hysteresis).  The window must be full
    before the first escalation so a single-arrival blip can't degrade
    the pool."""
    if policy.max_stage == 0:
        return 0
    if len(window) < policy.pressure_window:
        return stage
    recent = list(window)[-policy.pressure_window:]
    avg = sum(recent) / len(recent)
    if avg >= policy.degrade_hi:
        target = 2
    elif avg >= policy.degrade_lo:
        target = 1
    else:
        target = 0
    target = min(target, policy.max_stage)
    if target > stage:
        return stage + 1
    if target < stage and avg <= policy.restore_below:
        return stage - 1
    return stage


def slo_attainment(n_completed: int, n_total: int) -> float:
    """Fraction of offered requests that completed (the rest were shed
    or rejected).  With deterministic scheduling this is a pure function
    of (seed, topology, failplan) — the drills pin it."""
    return n_completed / max(n_total, 1)
