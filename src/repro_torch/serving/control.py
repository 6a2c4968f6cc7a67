"""Serving control plane: the replicated admission state machine and the
transports that carry its deltas (DESIGN.md §9).

The first ``ShardedScheduler`` *was* the simulated gossip: one authoritative
in-process queue playing every host at once.  This module splits that into
the three pieces a real multi-controller deployment needs:

  * **A pure state-machine core** — ``ControlState`` plus
    ``apply_deltas(state, deltas) -> state``: the replicated admission
    state every host maintains, advanced ONLY by applying scheduling
    deltas (request arrivals, slot releases).  ``compute_admissions`` is
    the deterministic admission function over that state (visible-ready
    requests ordered by (arrival, home, rid) -> visible-free slots in
    global slot order).  Because every host applies the same delta
    sequence and evaluates the same pure functions, all replicas agree
    without any further coordination.
  * **A pluggable ``Transport``** — the only component that knows how
    deltas move between hosts.  ``SimTransport`` is the original in-process
    gossip reduced to just a transport (one global delay queue);
    ``CollectiveTransport`` carries per-host deltas over a fixed-size
    padded all_gather each step — the jax.distributed-ready protocol
    (the device collective itself is injected from serving/collective.py;
    the default numpy loopback computes the identical merged view, so the
    protocol logic is testable without devices).
  * **Compaction planning** — ``plan_compaction`` turns a fragmented
    visible occupancy into a host-local slot permutation.  It is a pure
    function of replicated state, so every host computes the identical
    remap at the identical step WITHOUT gossiping it; the ``COMPACT``
    event is recorded in the log for exact replay, never transported.

Release deltas are resolved **by rid**, not by slot id: a COMPACT remap
may land between a release's production and its visibility, so the slot
number in the delta can be stale — the rid's current slot never is.

**Membership + failure (DESIGN.md §10)**: ``ControlState`` carries a
live-host set and an epoch counter.  A ``HOST_DOWN`` delta (reported by
the lowest surviving host, carrying the dead host's id in its rid field)
travels the same transport as everything else; applying it reclaims the
dead host's slot range and re-queues its in-flight requests under their
ORIGINAL (arrival_step, home) keys, so every replica computes the
identical FIFO-order-preserving recovery.  Both transports carry a
per-round replicated-state digest and raise ``ReplicaDivergence`` the
round any host's digest disagrees — the "replicas must crash, not
desynchronize" invariant, enforced rather than commented — plus a
per-round deadline that turns an injected hang into ``TransportTimeout``.

Everything here is deliberately JAX-free (numpy only) so the hypothesis
suite can drive thousands of random topologies/delays/traffic patterns
against the protocol in microseconds.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Delta kinds.  COMPACT is intentionally NOT a delta kind: compaction is a
# synchronous pure function of replicated state (see module docstring).
ARRIVE = 0
RELEASE = 1
HOST_DOWN = 2        # membership: rid field carries the DEAD host's id
_PAD = -1            # kind value of padding rows in the collective buffer
_DIGEST = -2         # transport-internal row kind: replicated-state digest
DELTA_FIELDS = 5     # (kind, step, home, rid, slot)

# Rounds whose injected hang exceeds this many virtual time units raise
# TransportTimeout instead of stalling the pool forever.  Inert without a
# FailPlan (real rounds have no virtual duration).
DEFAULT_ROUND_DEADLINE = 16


class ReplicaDivergence(RuntimeError):
    """A replica's state digest disagreed with its peers — the control
    plane is no longer replicated and MUST crash, not desynchronize."""


class TransportTimeout(RuntimeError):
    """An exchange round exceeded the transport's per-round deadline."""


@dataclasses.dataclass(frozen=True)
class Delta:
    """One scheduling event in flight.

    ``step`` is the event's logical production step — the arrival step for
    ARRIVE, the release step for RELEASE, the death-report step for
    HOST_DOWN; visibility is always ``step + delay`` regardless of when
    the transport physically moves the bytes (a fast-forwarded engine may
    exchange late; the schedule must not depend on that).

    For HOST_DOWN, ``home`` is the REPORTING host (lowest survivor) and
    ``rid`` carries the dead host's id — the victim cannot report its own
    death.
    """

    kind: int
    step: int
    home: int        # producing host (the slot's owner for RELEASE)
    rid: int
    slot: int = -1   # RELEASE: global slot id at production time;
                     # ARRIVE: the request's deadline_step (-1 = none)

    def encode(self) -> Tuple[int, int, int, int, int]:
        return (self.kind, self.step, self.home, self.rid, self.slot)

    @staticmethod
    def decode(row: Sequence[int]) -> "Delta":
        kind, step, home, rid, slot = (int(x) for x in row)
        if kind not in (ARRIVE, RELEASE, HOST_DOWN):
            raise ValueError(f"undecodable delta kind {kind}")
        return Delta(kind, step, home, rid, slot)


def _delta_order(d: Delta):
    # apply order is semantically irrelevant (arrivals join a sorted set,
    # releases resolve by rid) but a fixed sort keeps replicas literally
    # identical, transcript for transcript.  Kind is the second key on
    # purpose: a RELEASE and a HOST_DOWN delivered in one poll apply
    # release-first, so a request finishing at the death step is retired,
    # never re-queued (DESIGN.md §10 on the release/death race).
    return (d.step, d.kind, d.home, d.rid, d.slot)


# ---------------------------------------------------------------------------
# Pure replicated state machine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ControlState:
    """The replicated admission state: what every host agrees on.

    ``pending`` holds only *visible* arrivals (the transport withholds a
    delta until ``step + delay``); ``occupant`` marks a slot free only
    once the release delta has applied — so "free in state" IS
    "visible-free" and no separate visibility bookkeeping exists here.

    ``admitted`` retains each occupant's original (arrival_step, home)
    admission key: HOST_DOWN re-queues a dead host's requests under that
    key, which is what makes recovery FIFO-order-preserving.  ``live``
    and ``epoch`` are the membership view; dead hosts' slots are never
    admission targets and ``epoch`` bumps once per death (the data plane
    keys its shrink on it).
    """

    slots_per_host: int
    pending: Dict[int, Tuple[int, int]]      # rid -> (arrival_step, home)
    occupant: List[int]                      # global slot -> rid, -1 free
    live: List[bool] = None                  # host -> alive (None: all)
    epoch: int = 0                           # bumps on every HOST_DOWN
    admitted: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)                # rid -> its admission key
    deadlines: Dict[int, int] = dataclasses.field(
        default_factory=dict)                # rid -> deadline_step (if any)

    def __post_init__(self):
        if self.live is None:
            self.live = [True] * self.n_hosts

    @classmethod
    def fresh(cls, n_hosts: int, slots_per_host: int) -> "ControlState":
        return cls(slots_per_host=slots_per_host, pending={},
                   occupant=[-1] * (n_hosts * slots_per_host))

    @property
    def n_slots(self) -> int:
        return len(self.occupant)

    @property
    def n_hosts(self) -> int:
        return self.n_slots // self.slots_per_host

    def copy(self) -> "ControlState":
        return ControlState(self.slots_per_host, dict(self.pending),
                            list(self.occupant), list(self.live),
                            self.epoch, dict(self.admitted),
                            dict(self.deadlines))


def control_digest(state: ControlState) -> int:
    """A 31-bit digest of the full replicated state, stable across
    processes and platforms (crc32 of a canonical repr).  Every host
    reports it each transport round; a mismatch means the state machines
    diverged and the round raises ``ReplicaDivergence``."""
    canon = (state.slots_per_host,
             tuple(sorted(state.pending.items())),
             tuple(state.occupant),
             tuple(state.live),
             state.epoch,
             tuple(sorted(state.admitted.items())),
             tuple(sorted(state.deadlines.items())))
    return zlib.crc32(repr(canon).encode()) & 0x7FFFFFFF


def apply_deltas(state: ControlState,
                 deltas: Sequence[Delta]) -> ControlState:
    """THE replicated transition function: pure — returns a new state.

    Raises on protocol violations (double arrival, release of an
    unoccupied rid): a transport that delivers such a sequence is broken,
    and the hypothesis suite asserts these can't happen under any
    topology/delay/traffic.
    """
    out = state.copy()
    for d in sorted(deltas, key=_delta_order):
        if d.kind == ARRIVE:
            if d.rid in out.pending or d.rid in out.admitted:
                raise RuntimeError(f"request {d.rid} arrived twice")
            out.pending[d.rid] = (d.step, d.home)
            # ARRIVE reuses the otherwise-unused slot lane to replicate
            # the request's deadline_step (-1 = none): the shed decision
            # is a pure function of replicated state, so the deadline
            # must BE replicated state (DESIGN.md §14)
            if d.slot >= 0:
                out.deadlines[d.rid] = d.slot
        elif d.kind == RELEASE:
            # resolve by rid, NOT by the delta's slot field: a COMPACT
            # between production and visibility remaps slots, but the rid
            # still occupies exactly one
            try:
                slot = out.occupant.index(d.rid)
            except ValueError:
                raise RuntimeError(
                    f"release of rid {d.rid} which occupies no slot")
            out.occupant[slot] = -1
            out.admitted.pop(d.rid, None)
            out.deadlines.pop(d.rid, None)
        elif d.kind == HOST_DOWN:
            dead = d.rid
            if not (0 <= dead < out.n_hosts):
                raise RuntimeError(f"HOST_DOWN for unknown host {dead}")
            if not out.live[dead]:
                raise RuntimeError(f"host {dead} reported down twice")
            out.live[dead] = False
            out.epoch += 1
            # reclaim the dead range; re-queue its occupants under their
            # ORIGINAL admission keys so survivors recover them in FIFO
            # order relative to everything still pending
            lo = dead * out.slots_per_host
            for slot in range(lo, lo + out.slots_per_host):
                rid = out.occupant[slot]
                if rid == -1:
                    continue
                out.occupant[slot] = -1
                if rid not in out.admitted:  # pragma: no cover
                    raise RuntimeError(
                        f"rid {rid} occupies slot {slot} with no "
                        "admission record")
                out.pending[rid] = out.admitted.pop(rid)
        else:  # pragma: no cover
            raise RuntimeError(f"unknown delta kind {d.kind}")
    return out


def compute_admissions(state: ControlState) -> List[Tuple[int, int]]:
    """The deterministic admission function: visible-ready requests
    (ordered by (arrival_step, home, rid)) zipped onto visible-free slots
    (global slot order).  Pure — commit with ``commit_admission``."""
    ready = sorted(state.pending.items(),
                   key=lambda kv: (kv[1][0], kv[1][1], kv[0]))
    free = [s for s, r in enumerate(state.occupant)
            if r == -1 and state.live[s // state.slots_per_host]]
    return [(slot, rid) for slot, (rid, _) in zip(free, ready)]


def commit_admission(state: ControlState, slot: int, rid: int) -> None:
    """Synchronous transition: admissions are computed identically by
    every replica at the same step, so they need no delta.  The admission
    key moves from ``pending`` to ``admitted`` so a later HOST_DOWN can
    re-queue the rid under its original FIFO position."""
    if state.occupant[slot] != -1:  # pragma: no cover
        raise RuntimeError(f"slot {slot} double-assigned")
    state.occupant[slot] = rid
    # the deadline entry (if any) survives admission on purpose: a later
    # HOST_DOWN re-queues the rid, and its deadline did not die with the
    # host — the next shed pass judges it again (DESIGN.md §14)
    state.admitted[rid] = state.pending.pop(rid)


def commit_sheds(state: ControlState, rids: Sequence[int]) -> None:
    """Synchronous transition twin of ``commit_admission``: sheds are
    computed identically by every replica (admission.compute_sheds over
    replicated state), so they need no delta — each host just drops the
    rids from its queue mirror.  Raises (never asserts — queue integrity
    must survive ``python -O``) if a shed rid is not actually queued."""
    for rid in rids:
        if rid not in state.pending:
            raise RuntimeError(
                f"shed of rid {rid} which is not queued")
        state.pending.pop(rid)
        state.deadlines.pop(rid, None)


# ---------------------------------------------------------------------------
# Compaction planning (control plane of the data-plane remap)
# ---------------------------------------------------------------------------

def fragmentation(occupant: Sequence[int], slots_per_host: int,
                  host: int) -> float:
    """Dead-slot fraction below the host's highest live slot, normalized
    by the shard size — 0.0 for an empty or perfectly packed shard."""
    lo = host * slots_per_host
    live = [s for s in range(lo, lo + slots_per_host)
            if occupant[s] != -1]
    if not live:
        return 0.0
    holes = (live[-1] - lo + 1) - len(live)
    return holes / slots_per_host


def plan_compaction(occupant: Sequence[int], slots_per_host: int,
                    threshold: float) -> Optional[List[int]]:
    """Visible occupancy -> host-local remap permutation, or None.

    For every host whose ``fragmentation`` strictly exceeds ``threshold``,
    live slots are packed (order-preserving) into the dense prefix of the
    host's contiguous range, dead slots into the tail.  Returns
    ``perm`` with ``perm[new_slot] = old_slot`` (gather convention — the
    data plane applies it as ``pool[:, perm]``), always a permutation of
    ``range(n_slots)`` that never crosses a host boundary; None when no
    host crosses the threshold or packing would change nothing.

    Pure function of replicated state: every host computes the identical
    plan at the identical step, so the remap needs no transport — only a
    COMPACT log event so replay stays exact.
    """
    n_slots = len(occupant)
    perm = list(range(n_slots))
    changed = False
    for host in range(n_slots // slots_per_host):
        if fragmentation(occupant, slots_per_host, host) <= threshold:
            continue
        lo = host * slots_per_host
        hi = lo + slots_per_host
        live = [s for s in range(lo, hi) if occupant[s] != -1]
        dead = [s for s in range(lo, hi) if occupant[s] == -1]
        packed = live + dead
        if packed != perm[lo:hi]:
            perm[lo:hi] = packed
            changed = True
    return perm if changed else None


def invert_perm(perm: Sequence[int]) -> List[int]:
    """inv[old_slot] = new_slot for a gather-convention permutation."""
    inv = [0] * len(perm)
    for new, old in enumerate(perm):
        inv[old] = new
    return inv


# ---------------------------------------------------------------------------
# Event log (the ONE implementation shared by Scheduler, ShardedScheduler
# and the model-free replay — satellite dedupe)
# ---------------------------------------------------------------------------

class HostShard:
    """One host's slice of the global slot pool: the contiguous global
    slot range [host * slots_per_host, (host+1) * slots_per_host) plus the
    host-local event log.  Events carry GLOBAL slot ids and the global
    event seq, so the merged log is reconstructible from the per-host logs
    (linearization — tested in tests/test_property.py)."""

    def __init__(self, host: int, slots_per_host: int):
        self.host = host
        self.slots_per_host = slots_per_host
        self.lo = host * slots_per_host
        self.hi = (host + 1) * slots_per_host
        self.admissions: List[Tuple[int, int, int, int]] = []
        self.releases: List[Tuple[int, int, int, int]] = []
        # (step, local perm tuple over the host's GLOBAL slot ids, seq) —
        # recorded only when this host's range actually moved
        self.compactions: List[Tuple[int, Tuple[int, ...], int]] = []
        # failure-path events (same (step, slot, rid, seq) shape):
        # rejects free a slot whose prefill permanently failed; reclaims
        # free a dead host's slot when its HOST_DOWN applies
        self.rejects: List[Tuple[int, int, int, int]] = []
        self.reclaims: List[Tuple[int, int, int, int]] = []
        # (step, rid, reason, seq) — sheds vacate no slot (the rid was
        # still queued), so they are attributed to the request's HOME
        # host rather than a slot owner
        self.sheds: List[Tuple[int, int, int, int]] = []

    def owns(self, gslot: int) -> bool:
        return self.lo <= gslot < self.hi


class EventLog:
    """Monotonic scheduling event log: (step, slot, rid, seq) admission /
    release tuples plus (step, perm, seq) compactions, with optional
    per-host mirrors.  ``seq`` is the single global monotonic counter —
    several events can share one clock step (release + re-admit at the
    same tick), and every soundness check orders by seq."""

    def __init__(self, n_hosts: int = 0, slots_per_host: int = 0):
        self.admissions: List[Tuple[int, int, int, int]] = []
        self.releases: List[Tuple[int, int, int, int]] = []
        self.compactions: List[Tuple[int, Tuple[int, ...], int]] = []
        self.rejects: List[Tuple[int, int, int, int]] = []
        self.reclaims: List[Tuple[int, int, int, int]] = []
        # (step, rid, reason, seq) — overload sheds, merged + per-home
        self.sheds: List[Tuple[int, int, int, int]] = []
        # (step, dead host, epoch, seq) — merged only (not slot-owned)
        self.host_downs: List[Tuple[int, int, int, int]] = []
        # (step, from_stage, to_stage, seq) — degrade-ladder moves,
        # merged only: the stage is global replicated state, every host
        # executes the identical transition (DESIGN.md §14)
        self.degrades: List[Tuple[int, int, int, int]] = []
        self.hosts = [HostShard(h, slots_per_host)
                      for h in range(n_hosts)] if slots_per_host else []
        self._seq = 0

    def _host(self, gslot: int) -> Optional[HostShard]:
        if not self.hosts:
            return None
        return self.hosts[gslot // self.hosts[0].slots_per_host]

    def admission(self, step: int, slot: int, rid: int):
        ev = (step, slot, rid, self._seq)
        self._seq += 1
        self.admissions.append(ev)
        shard = self._host(slot)
        if shard is not None:
            shard.admissions.append(ev)
        return ev

    def release(self, step: int, slot: int, rid: int):
        ev = (step, slot, rid, self._seq)
        self._seq += 1
        self.releases.append(ev)
        shard = self._host(slot)
        if shard is not None:
            shard.releases.append(ev)
        return ev

    def reject(self, step: int, slot: int, rid: int):
        ev = (step, slot, rid, self._seq)
        self._seq += 1
        self.rejects.append(ev)
        shard = self._host(slot)
        if shard is not None:
            shard.rejects.append(ev)
        return ev

    def reclaim(self, step: int, slot: int, rid: int):
        ev = (step, slot, rid, self._seq)
        self._seq += 1
        self.reclaims.append(ev)
        shard = self._host(slot)
        if shard is not None:
            shard.reclaims.append(ev)
        return ev

    def shed(self, step: int, rid: int, reason: int, home: int = 0):
        ev = (step, rid, reason, self._seq)
        self._seq += 1
        self.sheds.append(ev)
        if self.hosts:
            self.hosts[home].sheds.append(ev)
        return ev

    def degrade(self, step: int, old: int, new: int):
        ev = (step, old, new, self._seq)
        self._seq += 1
        self.degrades.append(ev)
        return ev

    def host_down(self, step: int, host: int, epoch: int):
        ev = (step, host, epoch, self._seq)
        self._seq += 1
        self.host_downs.append(ev)
        return ev

    def compaction(self, step: int, perm: Sequence[int]):
        ev = (step, tuple(int(p) for p in perm), self._seq)
        self._seq += 1
        self.compactions.append(ev)
        for shard in self.hosts:
            local = ev[1][shard.lo:shard.hi]
            if local != tuple(range(shard.lo, shard.hi)):
                shard.compactions.append((step, local, ev[2]))
        return ev


def replay_slot_log(admissions, releases, compactions, n_slots: int,
                    rejects=(), reclaims=()):
    """THE shared event-log replay (satellite dedupe): reconstruct slot
    occupancy from a merged log, asserting soundness at every event —
    no slot double-assigned, every release matches the occupying rid
    (through any COMPACT remaps), no live request silently dropped by a
    remap (COMPACT perms are exact permutations).  Returns the final
    occupancy (rid or None per slot).

    ``rejects`` (prefill permanently failed) and ``reclaims`` (slot freed
    by a HOST_DOWN) vacate a slot exactly like releases — the replay
    checks the same occupant-match invariant for them, which is what lets
    a reclaimed rid be re-admitted later without tripping the
    double-assignment check.

    Used by tests/conftest.assert_slot_log_sound, the multi-host sim
    verdicts, and the hypothesis compaction/chaos properties.
    """
    events = (
        [(seq, 0, slot, rid) for step, slot, rid, seq in admissions]
        + [(seq, 1, slot, rid) for step, slot, rid, seq in
           list(releases) + list(rejects) + list(reclaims)]
        + [(seq, 2, perm, None) for step, perm, seq in compactions])
    occ: List[Optional[int]] = [None] * n_slots
    for ev in sorted(events, key=lambda e: e[0]):
        _, kind, a, b = ev
        if kind == 0:
            assert occ[a] is None, f"slot {a} double-assigned (rid {b})"
            occ[a] = b
        elif kind == 1:
            assert occ[a] == b, (
                f"slot {a} released with rid {b} but occupied by {occ[a]}")
            occ[a] = None
        else:
            perm = list(a)
            assert sorted(perm) == list(range(n_slots)), (
                "COMPACT event is not a permutation — live slots dropped")
            occ = [occ[p] for p in perm]
    return occ


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class Transport:
    """Delta movement contract (DESIGN.md §9/§10).

    ``send`` accepts a delta produced by its home host.  ``poll(now)``
    returns every delta whose visibility step (``delta.step + delay``) is
    <= now, exactly once, in any order (``apply_deltas`` sorts).
    ``pending_release_vis`` lists visibility steps of RELEASE deltas still
    in flight — the scheduler's fast-forward clock needs them;
    ``pending_recovery_vis`` does the same for HOST_DOWN deltas (the run
    loop must keep ticking until a death's reclaims apply).  Transports
    never interpret deltas beyond the kind/step fields.

    Failure-model hooks (inert when ``failpoints`` is None, which the
    scheduler wires): ARRIVE visibility is ``arrive_visibility(step)`` so
    an injected arrival delay stretches only arrivals — RELEASE and
    HOST_DOWN always travel at the base delay (DESIGN.md §10 explains why
    that asymmetry is load-bearing).  ``poll(now, digest=...)`` carries
    every host's reported state digest through the round and raises
    ``ReplicaDivergence`` on any mismatch; a round whose injected hang
    exceeds ``deadline`` raises ``TransportTimeout``.
    """

    delay: int
    failpoints = None                 # Optional[FailPlan]; scheduler wires
    deadline: Optional[int] = DEFAULT_ROUND_DEADLINE
    n_hosts: Optional[int] = None     # needed for per-host digest reports

    def send(self, delta: Delta) -> None:
        raise NotImplementedError

    def poll(self, now: int, digest: Optional[int] = None) -> List[Delta]:
        raise NotImplementedError

    def pending_release_vis(self) -> List[int]:
        raise NotImplementedError

    def pending_recovery_vis(self) -> List[int]:
        raise NotImplementedError

    # -- shared failure-model helpers ----------------------------------
    def arrive_visibility(self, step: int) -> int:
        """Visibility step of an ARRIVE delta produced at ``step``."""
        extra = (self.failpoints.arrive_extra_delay(step)
                 if self.failpoints is not None else 0)
        return step + self.delay + extra

    def _visibility(self, d: Delta) -> int:
        return (self.arrive_visibility(d.step) if d.kind == ARRIVE
                else d.step + self.delay)

    def _round_guard(self, now: int) -> None:
        if self.failpoints is None or self.deadline is None:
            return
        hang = self.failpoints.round_hang(now)
        if hang > self.deadline:
            raise TransportTimeout(
                f"exchange round at step {now} hung for {hang} units "
                f"(deadline {self.deadline})")

    def _reported_digests(self, now: int, digest: int) -> List[int]:
        """What each replica reports this round: the replicated digest,
        XOR any injected corruption (a stand-in for genuine divergence —
        in a real deployment each host computes its own digest)."""
        n = self.n_hosts if self.n_hosts else 1
        if self.failpoints is None:
            return [digest] * n
        return [digest ^ self.failpoints.digest_mask(h, now)
                for h in range(n)]

    @staticmethod
    def _check_digests(now: int, reported: Sequence[int]) -> None:
        if len(set(reported)) > 1:
            bad = [h for h, v in enumerate(reported) if v != reported[0]]
            raise ReplicaDivergence(
                f"state digest mismatch at step {now}: hosts {bad} "
                f"disagree ({reported})")


class SimTransport(Transport):
    """The original in-process gossip, reduced to *just a transport*: one
    global delay queue.  A delta sent at logical step t is delivered by the first
    poll with ``now >= t + delay`` — including to the producing host
    (uniform visibility is what makes the admission function replicable).
    """

    def __init__(self, delay: int = 1, *, failpoints=None,
                 deadline: Optional[int] = DEFAULT_ROUND_DEADLINE,
                 n_hosts: Optional[int] = None):
        assert delay >= 0
        self.delay = delay
        self.failpoints = failpoints
        self.deadline = deadline
        self.n_hosts = n_hosts
        self._flight: List[Tuple[int, int, Delta]] = []
        self._n = 0

    def send(self, delta: Delta) -> None:
        self._flight.append((self._visibility(delta), self._n, delta))
        self._n += 1

    def poll(self, now: int, digest: Optional[int] = None) -> List[Delta]:
        self._round_guard(now)
        if digest is not None:
            self._check_digests(now, self._reported_digests(now, digest))
        due = sorted(e for e in self._flight if e[0] <= now)
        self._flight = [e for e in self._flight if e[0] > now]
        return [d for _, _, d in due]

    def pending_release_vis(self) -> List[int]:
        return [v for v, _, d in self._flight if d.kind == RELEASE]

    def pending_recovery_vis(self) -> List[int]:
        return [v for v, _, d in self._flight if d.kind == HOST_DOWN]


class CollectiveTransport(Transport):
    """Delta exchange over a fixed-size padded all_gather — the
    jax.distributed-ready protocol (ROADMAP follow-up a).

    Every poll runs >= 1 exchange round; a round stacks each host's
    outbox into its row of a ``(n_hosts, capacity, DELTA_FIELDS)`` int32
    buffer (padding rows carry kind=-1) and gathers the stack so every
    host receives the identical ``(n_hosts, capacity, F)`` merged view.
    The buffer is FIXED-SIZE on purpose: the collective's shape never
    depends on traffic, so the gather compiles exactly once and a real
    multi-controller deployment never negotiates lengths; a burst that
    overflows ``capacity`` simply runs extra rounds of the same
    executable (outboxes drain FIFO, so visibility order is preserved —
    and visibility is computed from the PRODUCTION step, so late physical
    delivery can never reorder the schedule).

    ``gather`` maps the stacked buffer ``(n_hosts, C+1, F)`` to every
    host's received view ``(n_hosts, n_hosts, C+1, F)``; the default
    numpy loopback computes exactly what all_gather computes, which is
    how the hypothesis equivalence sweep drives the protocol without
    devices.  Serving injects the device collective
    (serving/collective.py) — per host's row lives on its data shard and
    jax.lax.all_gather moves it.  The per-host views are asserted
    identical every round, and the last row of each host's buffer slice
    carries that host's replicated-state digest: a digest mismatch in the
    gathered view raises ``ReplicaDivergence`` within the round — a
    transport whose replicas diverge must crash, not desynchronize the
    pool.
    """

    def __init__(self, n_hosts: int, delay: int = 1, capacity: int = 8,
                 gather: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None, *, failpoints=None,
                 deadline: Optional[int] = DEFAULT_ROUND_DEADLINE):
        assert n_hosts >= 1 and delay >= 0 and capacity >= 1
        self.n_hosts = n_hosts
        self.delay = delay
        self.capacity = capacity
        self.failpoints = failpoints
        self.deadline = deadline
        self._gather = gather if gather is not None else self._loopback
        self._outbox = [deque() for _ in range(n_hosts)]
        self._inbox: List[Tuple[int, int, Delta]] = []
        self._n = 0
        self.rounds = 0          # exchange rounds run (tests/bench)
        self.polls = 0

    @staticmethod
    def _loopback(buf: np.ndarray) -> np.ndarray:
        # broadcast == all_gather: every host receives the full stack
        return np.broadcast_to(buf[None], (buf.shape[0],) + buf.shape)

    def send(self, delta: Delta) -> None:
        assert 0 <= delta.home < self.n_hosts
        self._outbox[delta.home].append(delta)

    def _exchange_round(self, now: int,
                        digest: Optional[int] = None) -> None:
        self._round_guard(now)
        # capacity delta rows + 1 digest row per host: the buffer stays
        # FIXED-SIZE (shape never depends on traffic or failures), so the
        # gather still compiles exactly once
        buf = np.full((self.n_hosts, self.capacity + 1, DELTA_FIELDS),
                      _PAD, np.int32)
        for h, box in enumerate(self._outbox):
            for i in range(min(self.capacity, len(box))):
                buf[h, i] = box.popleft().encode()
        if digest is not None:
            for h, rep in enumerate(self._reported_digests(now, digest)):
                buf[h, self.capacity] = (_DIGEST, now, h, rep, -1)
        views = np.asarray(self._gather(buf))
        assert views.shape == (self.n_hosts,) + buf.shape, views.shape
        for h in range(1, self.n_hosts):
            assert (views[h] == views[0]).all(), (
                "collective replicas diverged — hosts received different "
                "merged delta buffers")
        if digest is not None:
            self._check_digests(
                now, [int(views[0][h, self.capacity, 3])
                      for h in range(self.n_hosts)])
        for row in views[0].reshape(-1, DELTA_FIELDS):
            if row[0] in (_PAD, _DIGEST):
                continue
            d = Delta.decode(row)
            self._inbox.append((self._visibility(d), self._n, d))
            self._n += 1
        self.rounds += 1

    def poll(self, now: int, digest: Optional[int] = None) -> List[Delta]:
        self.polls += 1
        self._exchange_round(now, digest)      # the per-step heartbeat
        while any(self._outbox):               # fixed-size overflow rounds
            self._exchange_round(now, digest)
        due = sorted(e for e in self._inbox if e[0] <= now)
        self._inbox = [e for e in self._inbox if e[0] > now]
        return [d for _, _, d in due]

    def pending_release_vis(self) -> List[int]:
        out = [d.step + self.delay for box in self._outbox for d in box
               if d.kind == RELEASE]
        out += [v for v, _, d in self._inbox if d.kind == RELEASE]
        return out

    def pending_recovery_vis(self) -> List[int]:
        out = [d.step + self.delay for box in self._outbox for d in box
               if d.kind == HOST_DOWN]
        out += [v for v, _, d in self._inbox if d.kind == HOST_DOWN]
        return out
