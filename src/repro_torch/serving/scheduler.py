"""Request queues + slot schedulers for the continuous-batching engine.

Deliberately JAX-free: admission policy is host-side control flow over a
fixed pool of cache slots (the device-side pool lives in engine.py /
sharded_pool.py), so the invariants — slot conservation, FIFO admission
among ready requests, no starvation, and (sharded) no cross-host slot
double-claim — are testable with hypothesis in microseconds.

Time is measured in *decode steps*: the engine advances the clock once
per jitted decode step, and a request with ``arrival_step = t`` becomes
admissible the first time the clock reaches t.  That makes every schedule
a deterministic function of (workload, n_slots) — the property CI runs on
CPU without ever touching the model.

Two schedulers live here:

  * ``Scheduler`` — the single-host FIFO slot pool.
  * ``ShardedScheduler`` — the multi-host admission protocol (DESIGN.md
    §8/§9), now an orchestrator over the *control plane* in
    serving/control.py: the replicated state machine advances only via
    ``control.apply_deltas`` over deltas carried by a pluggable
    ``Transport`` (in-process simulated gossip, or the fixed-size padded
    all_gather collective), and admission is the pure
    ``control.compute_admissions`` every host evaluates identically.
    A host then *executes* only the admissions that land in its own slot
    range; no two hosts can ever claim the same slot or the same request.
    With ``compact_threshold`` set, the control plane additionally plans
    host-local slot compactions (``control.plan_compaction``) and records
    them as COMPACT log events so replay stays integer-exact.

``run_schedule`` is the ONE admit -> fast-forward -> decode -> retire
loop shared by the real ``ShardedEngine.run`` and the model-free
``simulate_sharded_schedule`` — the engine's event log equals the
simulation's by construction, compaction decisions included.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving import admission as admission_lib
from repro_torch.serving import control as control_lib
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.control import (ARRIVE, HOST_DOWN, RELEASE,
                                   ControlState, Delta, EventLog,
                                   HostShard, SimTransport, Transport)
from repro_torch.serving.failpoints import FailPlan, PREFILL_MAX_ATTEMPTS


@dataclasses.dataclass
class Request:
    """One serving request, plus the bookkeeping the engine fills in."""

    rid: int
    prompt: np.ndarray                 # (S,) int32 token / item ids
    max_gen: int                       # generation budget (incl. 1st token)
    arrival_step: int = 0              # decode-step clock of arrival
    home: int = 0                      # host shard the request arrived at
    # request kind (DESIGN.md §11): "lm" loops the autoregressive decode
    # step until a stop condition; "oneshot" takes exactly one recover
    # step after prefill and retires (the retrieval scenario's shape)
    kind: str = "lm"
    # held-out relevant item ids for offline ranking eval (-1-padded);
    # never read by the engines — carried so the eval path needs no side
    # table keyed by rid
    targets: Optional[np.ndarray] = None
    # SLO deadline (DESIGN.md §14): the last decode-step clock tick at
    # which admission still meets the request's latency budget; -1 means
    # no deadline (the pre-PR-10 behaviour — never shed on time).  A
    # queued request with ``now > deadline_step`` is shed by the
    # admission policy instead of admitted late.
    deadline_step: int = -1

    # engine-filled results
    tokens: List[int] = dataclasses.field(default_factory=list)
    topk_ids: List[int] = dataclasses.field(default_factory=list)
    topk_scores: List[float] = dataclasses.field(default_factory=list)
    admitted_step: int = -1
    finish_step: int = -1
    slot: int = -1
    rejected: bool = False             # prefill permanently failed
    requeues: int = 0                  # times reclaimed by a HOST_DOWN
    shed: bool = False                 # dropped by the admission policy

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def done(self) -> bool:
        return self.finish_step >= 0

    def fresh_copy(self, *, arrival_step: Optional[int] = None) -> "Request":
        """A new Request carrying ONLY the workload-defined fields.

        The engine-filled bookkeeping (tokens, admitted_step, slot, ...)
        is an *output* of one engine run, not an input; replaying a
        workload list through two engines (every A/B driver) must not
        share instances or the second run starts from the first run's
        state.  burst_workload and the A/B benches build their replays
        from fresh copies (see loadgen.assert_fresh_instances)."""
        return Request(
            rid=self.rid, prompt=np.array(self.prompt, copy=True),
            max_gen=self.max_gen,
            arrival_step=(self.arrival_step if arrival_step is None
                          else arrival_step),
            home=self.home, kind=self.kind,
            targets=(None if self.targets is None
                     else np.array(self.targets, copy=True)),
            deadline_step=self.deadline_step)


@dataclasses.dataclass
class ServeStats:
    """Deterministic schedule counters (+ wall-clock, never asserted on).
    Lives here, JAX-free, so the model-free simulation and the engines
    fill the identical structure."""

    decode_steps: int = 0
    idle_steps: int = 0              # clock ticks with an empty pool
    slot_steps_total: int = 0        # n_slots * decode_steps
    slot_steps_active: int = 0       # slot-steps spent on a live request
    prefills: int = 0
    tokens_out: int = 0
    compactions: int = 0             # COMPACT events executed
    # failure path (all zero on a fault-free run; as_row() omits them on
    # purpose — the committed bench baselines only carry them on rows
    # that exercise the failure model)
    host_downs: int = 0              # HOST_DOWN deltas applied
    requeued: int = 0                # in-flight requests reclaimed
    rejects: int = 0                 # prefill-exhausted REJECTs
    # overload path (DESIGN.md §14; zero on an unloaded run, omitted
    # from as_row() like the failure counters)
    sheds: int = 0                   # requests dropped by the policy
    degrades: int = 0                # degrade-ladder transitions executed
    wall_s: float = 0.0

    @property
    def utilization(self) -> float:
        if not self.slot_steps_total:
            return 1.0
        return self.slot_steps_active / self.slot_steps_total

    def as_row(self) -> Dict[str, float]:
        return {"decode_steps": self.decode_steps,
                "idle_steps": self.idle_steps,
                "slot_steps_total": self.slot_steps_total,
                "slot_steps_active": self.slot_steps_active,
                "utilization": round(self.utilization, 4),
                "prefills": self.prefills,
                "tokens_out": self.tokens_out,
                "compactions": self.compactions}


class RequestQueue:
    """Arrival-ordered queue; FIFO among requests whose arrival_step has
    passed.  push() order breaks arrival-step ties (stable).

    ``arrival_key`` customizes the arrival clock per request (default:
    ``r.arrival_step``) — the single-host engine passes the failpoint
    surge compression here so injected overload reshapes the FIFO key
    itself, exactly as the sharded ARRIVE deltas do."""

    def __init__(self, requests=(), *, arrival_key=None):
        self._key = (arrival_key if arrival_key is not None
                     else (lambda r: r.arrival_step))
        self._pending: Deque[Request] = deque(
            sorted(requests, key=self._key))

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, req: Request) -> None:
        # maintain arrival order under online pushes
        self._pending.append(req)
        if (len(self._pending) > 1 and self._key(self._pending[-2])
                > self._key(req)):
            self._pending = deque(
                sorted(self._pending, key=self._key))

    def peek_ready(self, now: int) -> Optional[Request]:
        if self._pending and self._key(self._pending[0]) <= now:
            return self._pending[0]
        return None

    def pop_ready(self, now: int) -> Optional[Request]:
        if self.peek_ready(now) is None:
            return None
        return self._pending.popleft()

    def next_arrival(self) -> Optional[int]:
        return self._key(self._pending[0]) if self._pending else None

    def arrival_of(self, req: Request) -> int:
        """The queue's (possibly surge-compressed) arrival clock for
        ``req`` — what the admission policy sheds against."""
        return self._key(req)

    def visible(self, now: int) -> List[Request]:
        """Requests that have arrived (arrival_step <= now) but are
        still queued — the single-host analogue of the replicated
        visible-pending set the admission policy sheds from."""
        return [r for r in self._pending if self._key(r) <= now]

    def remove(self, rids) -> List[Request]:
        """Drop (and return) the given rids from the queue — the shed
        path.  Raises (never asserts) if any rid is not queued: queue
        integrity must survive ``python -O``."""
        rids = set(rids)
        out = [r for r in self._pending if r.rid in rids]
        if len(out) != len(rids):
            missing = rids - {r.rid for r in out}
            raise RuntimeError(
                f"shed of rids {sorted(missing)} which are not queued")
        self._pending = deque(r for r in self._pending
                              if r.rid not in rids)
        return out


class Scheduler:
    """Fixed pool of `n_slots` cache slots; admits FIFO into free slots.

    Raises on any invariant violation (double-assign, double-release) —
    the engine relies on these being impossible, and the hypothesis suite
    drives random admit/release sequences against them.  Event logging is
    the shared ``control.EventLog`` (same format as the sharded log, so
    one replay helper checks both).
    """

    def __init__(self, n_slots: int):
        assert n_slots >= 1
        self.n_slots = n_slots
        self._occupant: List[Optional[Request]] = [None] * n_slots
        self.log = EventLog()

    @property
    def admissions(self):
        return self.log.admissions

    @property
    def releases(self):
        return self.log.releases

    @property
    def compactions(self):
        return self.log.compactions

    @property
    def rejects(self):
        return self.log.rejects

    @property
    def sheds(self):
        return self.log.sheds

    @property
    def degrades(self):
        return self.log.degrades

    # ------------------------------------------------------------------
    @property
    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._occupant) if r is None]

    @property
    def active(self) -> Dict[int, Request]:
        return {s: r for s, r in enumerate(self._occupant) if r is not None}

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self.free_slots)

    # ------------------------------------------------------------------
    def admit(self, queue: RequestQueue, now: int) -> List[Request]:
        """Admit ready requests (FIFO) into free slots; returns them with
        .slot/.admitted_step filled."""
        admitted = []
        for slot in self.free_slots:
            req = queue.pop_ready(now)
            if req is None:
                break
            if self._occupant[slot] is not None:  # pragma: no cover
                raise RuntimeError(f"slot {slot} double-assigned")
            req.slot = slot
            req.admitted_step = now
            self._occupant[slot] = req
            self.log.admission(now, slot, req.rid)
            admitted.append(req)
        return admitted

    def release(self, slot: int, now: int) -> Request:
        req = self._occupant[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} released while free")
        req.finish_step = now
        self._occupant[slot] = None
        self.log.release(now, slot, req.rid)
        return req

    def reject(self, slot: int, now: int) -> Request:
        """Free a slot whose prefill permanently failed (REJECT event):
        the request finishes unserved instead of hanging the pool."""
        req = self._occupant[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} rejected while free")
        req.finish_step = now
        req.rejected = True
        self._occupant[slot] = None
        self.log.reject(now, slot, req.rid)
        return req


# ---------------------------------------------------------------------------
# Sharded (multi-host) admission: transport-carried replicated state machine
# ---------------------------------------------------------------------------

class ShardedScheduler:
    """Deterministic transported admission over per-host slot shards.

    Protocol (DESIGN.md §8/§9): all scheduling inputs — request arrivals
    (at their home host) and slot releases — become deltas on a
    ``Transport`` and reach *every* host (including the producer)
    ``gossip_delay`` steps after their production step.  The replicated
    ``ControlState`` advances only by ``control.apply_deltas`` over the
    delivered deltas, and admission at step ``now`` is the pure
    ``control.compute_admissions`` over that state.  Because every host
    applies the same deltas and evaluates the same function, the
    assignment is identical everywhere; each host executes only the
    admissions inside its own slot range, so a slot (or a request) can
    never be claimed twice.  ``gossip_delay=0`` degenerates to a single
    synchronous pool — the single-host ``Scheduler`` order.

    This class is the per-host orchestrator (every replica would run this
    same code); the default ``SimTransport`` reproduces the simulated
    gossip log integer-for-integer, and ``CollectiveTransport`` carries
    the identical deltas over a fixed-size padded all_gather.
    """

    def __init__(self, n_hosts: int, slots_per_host: int,
                 gossip_delay: int = 1, *,
                 transport: Optional[Transport] = None,
                 compact_threshold: Optional[float] = None,
                 failpoints: Optional[FailPlan] = None,
                 admission_policy: Optional[AdmissionPolicy] = None):
        assert n_hosts >= 1 and slots_per_host >= 1 and gossip_delay >= 0
        self.n_hosts = n_hosts
        self.slots_per_host = slots_per_host
        self.n_slots = n_hosts * slots_per_host
        self.transport = (SimTransport(gossip_delay) if transport is None
                          else transport)
        self.gossip_delay = self.transport.delay
        assert self.gossip_delay == gossip_delay, (
            "transport delay must match gossip_delay")
        self.compact_threshold = compact_threshold
        self.failpoints = failpoints if failpoints else None
        # one plan drives scheduler AND transport (kills here; arrival
        # delays / round hangs / digest corruption in the transport) so a
        # single spec replays the identical failure schedule everywhere
        if (self.failpoints is not None
                and getattr(self.transport, "failpoints", None) is None):
            self.transport.failpoints = self.failpoints
        if getattr(self.transport, "n_hosts", None) is None:
            self.transport.n_hosts = n_hosts
        self.state = ControlState.fresh(n_hosts, slots_per_host)
        self.log = EventLog(n_hosts, slots_per_host)
        self._occupant: List[Optional[Request]] = [None] * self.n_slots
        self._requests: Dict[int, Request] = {}   # pushed, not admitted
        self._unsent: Dict[int, Request] = {}     # ARRIVE delta not sent
        self._stepped_at = -1
        # overload policy (DESIGN.md §14): sheds + the degrade ladder are
        # synchronous pure functions of replicated state, evaluated in
        # begin_step exactly once per clock tick
        self.policy = admission_policy
        self.degrade_stage = admission_lib.STAGE_NORMAL
        self._pressure: Deque[float] = deque(
            maxlen=(admission_policy.pressure_window
                    if admission_policy is not None else 1))
        self._policy_stepped = -1
        self._new_sheds: List[Request] = []
        self._new_stages: List[Tuple[int, int]] = []
        # membership: physically-dead hosts (local knowledge, applied the
        # instant the kill lands) vs the replicated live view mirrored at
        # the last apply (reclaims run when the two diverge)
        self._dead_local: set = set()
        self._applied_live = [True] * n_hosts
        self._new_kills: List[int] = []
        self._new_host_downs: List[Tuple[int, List[Request]]] = []

    # ------------------------------------------------------------------
    @property
    def admissions(self):
        return self.log.admissions

    @property
    def releases(self):
        return self.log.releases

    @property
    def compactions(self):
        return self.log.compactions

    @property
    def rejects(self):
        return self.log.rejects

    @property
    def reclaims(self):
        return self.log.reclaims

    @property
    def sheds(self):
        return self.log.sheds

    @property
    def degrades(self):
        return self.log.degrades

    @property
    def host_downs(self):
        return self.log.host_downs

    @property
    def hosts(self) -> List[HostShard]:
        return self.log.hosts

    # ------------------------------------------------------------------
    def push(self, req: Request, host: Optional[int] = None) -> None:
        """Local arrival at its home host (its ARRIVE delta enters the
        transport once the clock reaches arrival_step; visible
        cluster-wide at arrival_step + gossip_delay).

        Queue-integrity violations raise real exceptions (never bare
        asserts, which ``python -O`` strips): a duplicate rid would
        corrupt the replicated pending map and every downstream FIFO
        property."""
        if host is not None:
            req.home = host
        if not 0 <= req.home < self.n_hosts:
            raise ValueError(
                f"rid {req.rid}: home {req.home} outside "
                f"[0, {self.n_hosts})")
        if req.rid in self._requests:
            raise ValueError(f"rid {req.rid} pushed twice")
        if any(r is not None and r.rid == req.rid
               for r in self._occupant):
            raise ValueError(
                f"rid {req.rid} pushed while already admitted")
        self._requests[req.rid] = req
        self._unsent[req.rid] = req

    def push_workloads(self, per_host: List[List[Request]]) -> None:
        assert len(per_host) == self.n_hosts
        for h, reqs in enumerate(per_host):
            for r in reqs:
                self.push(r, host=h)

    # ------------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_pending(self) -> int:
        return len(self._requests)

    @property
    def active(self) -> Dict[int, Request]:
        """Slots actually decoding: a physically-dead host's slots drop
        out the moment the kill lands (the hardware is gone), even though
        the replicated state reclaims them only at HOST_DOWN visibility."""
        return {s: r for s, r in enumerate(self._occupant)
                if r is not None
                and self.host_of(s) not in self._dead_local}

    @property
    def recovery_pending(self) -> bool:
        """True while a HOST_DOWN delta is still in flight — the run loop
        must keep ticking so the reclaim (and re-admission) can land."""
        return bool(self.transport.pending_recovery_vis())

    def host_of(self, gslot: int) -> int:
        return gslot // self.slots_per_host

    def is_dead_slot(self, gslot: int) -> bool:
        """True when the slot's host died physically — its assignments
        are zombies until the HOST_DOWN reclaim re-queues them."""
        return self.host_of(gslot) in self._dead_local

    @property
    def live_hosts(self) -> List[int]:
        return [h for h in range(self.n_hosts)
                if h not in self._dead_local]

    # ------------------------------------------------------------------
    def _eff_arrival(self, req: Request) -> int:
        """Arrival step after any injected surge compression — the step
        the ARRIVE delta carries, so the compressed traffic is the FIFO
        key everywhere (engine, sim, both transports)."""
        if self.failpoints is None:
            return req.arrival_step
        return self.failpoints.effective_arrival(req.arrival_step)

    def _flush_arrivals(self, now: int) -> None:
        due = [r for r in self._unsent.values()
               if self._eff_arrival(r) <= now]
        for r in due:
            if r.home in self._dead_local:
                # the front door never routes new arrivals to a dead
                # host: reroute deterministically to the lowest survivor
                r.home = self.live_hosts[0]
        for r in sorted(due, key=lambda r: (self._eff_arrival(r), r.home,
                                            r.rid)):
            # the slot lane of an ARRIVE delta replicates the deadline
            # (-1 = none) — see control.apply_deltas
            self.transport.send(Delta(ARRIVE, self._eff_arrival(r),
                                      r.home, r.rid, r.deadline_step))
            del self._unsent[r.rid]

    def kill_host(self, host: int, now: int) -> None:
        """Host ``host`` dies physically at ``now``: its slots stop
        decoding immediately (``active`` excludes them from this step
        on), and the lowest surviving host reports a HOST_DOWN delta —
        every replica reclaims the dead range identically when the delta
        becomes visible.  The victim cannot report its own death."""
        assert host not in self._dead_local, f"host {host} killed twice"
        survivors = [h for h in self.live_hosts if h != host]
        if not survivors:
            raise RuntimeError("cannot kill the last live host")
        self._dead_local.add(host)
        self._new_kills.append(host)
        self.transport.send(Delta(HOST_DOWN, now, survivors[0], host))

    def begin_step(self, now: int) -> Optional[List[int]]:
        """Advance the replicated state to ``now``: execute any planned
        host kills, flush due arrivals into the transport, run the
        digest-checked exchange, apply every delta that has become
        visible (reconciling membership — reclaims + re-queues — when a
        HOST_DOWN lands), then (with compaction enabled) evaluate the
        compaction plan.  Returns the remap permutation when this step
        compacts — the data plane must apply it BEFORE this step's
        admissions/decode.  Safe to call more than once per step (kills
        are once-only, polling is idempotent, a second compaction check
        sees the already-packed state)."""
        if self.failpoints is not None:
            for h in self.failpoints.kills_at(now):
                if h not in self._dead_local:
                    self.kill_host(h, now)
        self._flush_arrivals(now)
        # digest of the pre-exchange state: every replica reports it into
        # the round, so divergence crashes before it can schedule anything
        digest = control_lib.control_digest(self.state)
        delivered = self.transport.poll(now, digest=digest)
        if delivered:
            self.state = control_lib.apply_deltas(self.state, delivered)
            self._reconcile_membership(now)
        if self.policy is not None and self._policy_stepped != now:
            # once per clock tick (begin_step is re-entrant): sheds
            # first, then the pressure sample reflects the bounded queue
            self._policy_stepped = now
            self._apply_policy(now)
        self._stepped_at = now
        if self.compact_threshold is None:
            return None
        perm = control_lib.plan_compaction(
            self.state.occupant, self.slots_per_host,
            self.compact_threshold)
        if perm is None:
            return None
        self._execute_compaction(now, perm)
        return perm

    def _reconcile_membership(self, now: int) -> None:
        """Replicated deaths became visible: mirror the reclaim that
        ``apply_deltas`` already performed on ``state`` into the
        authoritative request map — log one reclaim per seized slot,
        reset each seized request's generation (its partial tokens died
        with the host; the decode contract regenerates them bit-identical
        on re-admission) and return it to the pending pool under its
        original arrival key."""
        for h in range(self.n_hosts):
            if not self._applied_live[h] or self.state.live[h]:
                continue
            self._applied_live[h] = False
            self._dead_local.add(h)   # remote-reported death (no-op here)
            reclaimed: List[Request] = []
            for gslot in range(h * self.slots_per_host,
                               (h + 1) * self.slots_per_host):
                req = self._occupant[gslot]
                if req is None:
                    continue
                self._occupant[gslot] = None
                self.log.reclaim(now, gslot, req.rid)
                req.slot = -1
                req.admitted_step = -1
                req.tokens = []
                req.requeues += 1
                assert req.rid not in self._requests
                self._requests[req.rid] = req
                reclaimed.append(req)
            self.log.host_down(now, h, self.state.epoch)
            self._new_host_downs.append((h, reclaimed))

    def _apply_policy(self, now: int) -> None:
        """The overload pass (DESIGN.md §14): shed expired / over-bound
        queued requests, then step the degrade ladder on the windowed
        pressure signal.  Every decision is a pure function of
        (replicated state, now, policy) — replicas compute identical
        sheds and identical stage moves with nothing transported, the
        same argument as plan_compaction."""
        sheds = admission_lib.compute_sheds(
            self.state.pending, self.state.deadlines, now, self.policy)
        if sheds:
            homes = {rid: self.state.pending[rid][1]
                     for rid, _ in sheds}
            control_lib.commit_sheds(self.state,
                                     [rid for rid, _ in sheds])
            for rid, reason in sheds:
                req = self._requests.pop(rid, None)
                if req is None:
                    raise RuntimeError(
                        f"shed rid {rid} unknown to the orchestrator")
                req.shed = True
                req.finish_step = now
                self.log.shed(now, rid, reason, homes[rid])
                self._new_sheds.append(req)
        live_slots = self.slots_per_host * sum(self.state.live)
        self._pressure.append(admission_lib.pressure(
            len(self.state.pending), live_slots))
        new = admission_lib.plan_stage(self._pressure, self.policy,
                                       self.degrade_stage)
        if new != self.degrade_stage:
            self.log.degrade(now, self.degrade_stage, new)
            self._new_stages.append((self.degrade_stage, new))
            self.degrade_stage = new

    def drain_sheds(self) -> List[Request]:
        out, self._new_sheds = self._new_sheds, []
        return out

    def drain_stage_changes(self) -> List[Tuple[int, int]]:
        out, self._new_stages = self._new_stages, []
        return out

    def drain_kills(self) -> List[int]:
        out, self._new_kills = self._new_kills, []
        return out

    def drain_host_downs(self) -> List[Tuple[int, List[Request]]]:
        out, self._new_host_downs = self._new_host_downs, []
        return out

    def _execute_compaction(self, now: int, perm: List[int]) -> None:
        # replicated state and the authoritative occupant map remap with
        # the same permutation; live requests learn their new slot id
        self.state.occupant = [self.state.occupant[p] for p in perm]
        self._occupant = [self._occupant[p] for p in perm]
        for new_slot, req in enumerate(self._occupant):
            if req is not None:
                req.slot = new_slot
        self.log.compaction(now, perm)

    # ------------------------------------------------------------------
    def admit(self, now: int) -> List[Request]:
        """Execute the replicated admission function at ``now``.  Returns
        admitted requests with .slot (GLOBAL id) / .admitted_step filled;
        the owning HostShard records the event."""
        if self._stepped_at != now:
            # direct callers (no data plane) may skip begin_step; with
            # compaction or an admission policy enabled the caller MUST
            # begin_step first, or the data plane would miss the remap /
            # the shed+degrade pass (a real exception — queue integrity
            # must survive ``python -O``)
            if (self.compact_threshold is not None
                    or self.policy is not None):
                raise RuntimeError(
                    "begin_step(now) must run before admit(now) when "
                    "compaction or an admission policy is enabled")
            self.begin_step(now)
        admitted = []
        for gslot, rid in control_lib.compute_admissions(self.state):
            control_lib.commit_admission(self.state, gslot, rid)
            req = self._requests.pop(rid)
            req.slot = gslot
            req.admitted_step = now
            self._occupant[gslot] = req
            self.log.admission(now, gslot, rid)
            admitted.append(req)
        return admitted

    def release(self, gslot: int, now: int) -> Request:
        req = self._occupant[gslot]
        if req is None:
            raise RuntimeError(f"slot {gslot} released while free")
        req.finish_step = now
        self._occupant[gslot] = None
        self.log.release(now, gslot, req.rid)
        # the freed slot re-enters the replicated pool only once its
        # RELEASE delta has travelled the transport (by rid — a COMPACT
        # may remap slot ids while the delta is in flight)
        self.transport.send(Delta(RELEASE, now, self.host_of(gslot),
                                  req.rid, gslot))
        return req

    def reject(self, gslot: int, now: int) -> Request:
        """Free a slot whose prefill permanently failed: a REJECT event
        locally, a plain RELEASE delta to the replicated pool (the slot
        is free either way — only the local log knows the request ended
        unserved instead of retired)."""
        req = self._occupant[gslot]
        if req is None:
            raise RuntimeError(f"slot {gslot} rejected while free")
        req.finish_step = now
        req.rejected = True
        self._occupant[gslot] = None
        self.log.reject(now, gslot, req.rid)
        self.transport.send(Delta(RELEASE, now, self.host_of(gslot),
                                  req.rid, gslot))
        return req

    # ------------------------------------------------------------------
    def next_event_time(self, now: int) -> Optional[int]:
        """Earliest step >= now at which an admission could become
        possible (a pending request gossips into visibility, an in-flight
        release frees a slot, or an in-flight HOST_DOWN re-queues its
        victims) — the engine fast-forwards the clock here when the pool
        is empty.  Returns ``now`` itself when a slot freed during this
        step's admissions is already visible (gossip_delay=0) while a
        visible-ready request waits: the driver re-admits without a clock
        tick instead of dropping the request."""
        evs = (self.transport.pending_release_vis()
               + self.transport.pending_recovery_vis())
        if not self._requests:
            # nothing queued, but an in-flight HOST_DOWN will re-queue
            # its victims at visibility — the clock must reach it
            cands = [c for c in evs if c > now]
            return min(cands) if cands else None
        ready_at = min(self.transport.arrive_visibility(
            self._eff_arrival(r)) for r in self._requests.values())
        if ready_at <= now and any(v <= now for v in evs):
            return now
        cands = [c for c in [ready_at] + evs if c > now]
        return min(cands) if cands else None


# ---------------------------------------------------------------------------
# The shared serve loop (engine AND model-free simulation)
# ---------------------------------------------------------------------------

class ScheduleClient:
    """Data-plane hooks for ``run_schedule``.  The engine implements the
    real pool (prefill pool, jitted decode, cache compaction); the
    model-free simulation implements integer placeholders.  Sharing the
    loop is what makes the engine's event log equal the simulation's by
    construction — compaction decisions included."""

    def prefill(self, reqs: List[Request]) -> List[Optional[int]]:
        """Admitted requests (in admission order) -> first token ids.
        ``None`` for a request whose prefill permanently failed (every
        retry exhausted): the loop REJECTs it instead of hanging."""
        raise NotImplementedError

    def stopped(self, req: Request, tok: int) -> bool:
        """Called after ``tok`` was appended to req.tokens."""
        return len(req.tokens) >= req.max_gen

    def start_slot(self, req: Request, first: int) -> None:
        """A non-stopped admission begins decoding in req.slot."""

    def decode(self, active: Dict[int, Request]) -> Dict[int, int]:
        """One pool decode step -> token id per live slot."""
        raise NotImplementedError

    def advance_slot(self, gslot: int, req: Request, tok: int) -> None:
        """Per live slot after a decode step (token already appended)."""

    def stop_slot(self, gslot: int) -> None:
        """A live slot retired (release already recorded)."""

    def compact(self, perm: List[int]) -> None:
        """Apply the COMPACT remap to the data plane (perm[new]=old)."""

    def host_killed(self, host: int) -> None:
        """``host`` died physically this step: its slot range must stop
        decoding NOW (before HOST_DOWN visibility)."""

    def host_down(self, host: int, reqs: List[Request]) -> None:
        """``host``'s death became visible; ``reqs`` were reclaimed and
        re-queued.  The data plane may scrub the dead range."""

    def set_stage(self, stage: int) -> None:
        """The degrade ladder moved to ``stage`` (DESIGN.md §14): the
        data plane swaps to that stage's PRE-BUILT decode callable —
        a jit swap, never a compile (the model-free sim ignores it;
        degradation is schedule-invariant by design)."""


def run_schedule(sched: ShardedScheduler, client: ScheduleClient,
                 stats: Optional[ServeStats] = None) -> ServeStats:
    """THE admit -> fast-forward -> decode -> retire loop (DESIGN.md §9),
    shared by ``ShardedEngine.run`` and ``simulate_sharded_schedule``.
    One clock tick per pool decode step; requests admitted this step emit
    their first (prefill) token before the step's decode."""
    stats = stats or ServeStats()
    stalls = 0
    now = 0
    while sched.n_pending or sched.n_active or sched.recovery_pending:
        perm = sched.begin_step(now)
        for host in sched.drain_kills():
            client.host_killed(host)
        for host, reqs in sched.drain_host_downs():
            stats.host_downs += 1
            stats.requeued += len(reqs)
            client.host_down(host, reqs)
        stats.sheds += len(sched.drain_sheds())
        for _, stage in sched.drain_stage_changes():
            stats.degrades += 1
            client.set_stage(stage)
        if perm is not None:
            stats.compactions += 1
            client.compact(perm)
        admitted = sched.admit(now)
        # an admission may land on a host that died physically while its
        # HOST_DOWN is still in flight — the replicated assignment cannot
        # know yet, and a dead host can neither prefill nor release.  The
        # slot sits as a zombie (excluded from `active`) until the
        # HOST_DOWN reclaim re-queues the request under its original key.
        live_admits = [r for r in admitted
                       if not sched.is_dead_slot(r.slot)]
        firsts = client.prefill(live_admits) if live_admits else []
        for req, first in zip(live_admits, firsts):
            if first is None:
                stats.rejects += 1
                sched.reject(req.slot, now)
                continue
            req.tokens.append(first)
            stats.prefills += 1
            stats.tokens_out += 1
            if client.stopped(req, first):
                sched.release(req.slot, now)
            else:
                client.start_slot(req, first)
        if not sched.n_active:
            nxt = sched.next_event_time(now)
            if nxt is None:
                break
            if nxt < now:  # pragma: no cover
                raise RuntimeError("scheduler clock went backwards")
            if nxt == now:
                # a slot freed during this step's admissions is already
                # visible (delay 0): re-admit at the same clock tick
                stalls += 1
                if not admitted and stalls > 2:  # pragma: no cover
                    raise RuntimeError("scheduler made no progress")
                continue
            stalls = 0
            stats.idle_steps += nxt - now
            now = nxt
            continue
        stalls = 0
        toks = client.decode(sched.active)
        stats.decode_steps += 1
        stats.slot_steps_total += sched.n_slots
        stats.slot_steps_active += sched.n_active
        # an injected slow_decode makes each decode step cost N clock
        # ticks: arrivals pile up during the slow steps, which is what
        # drives the pressure signal in the overload drills
        now += (sched.failpoints.decode_cost(now)
                if sched.failpoints is not None else 1)
        for gslot, req in list(sched.active.items()):
            tok = toks[gslot]
            req.tokens.append(tok)
            stats.tokens_out += 1
            client.advance_slot(gslot, req, tok)
            if client.stopped(req, tok):
                sched.release(gslot, now)
                client.stop_slot(gslot)
    return stats


class _SimClient(ScheduleClient):
    """Model-free placeholders: every request occupies its slot for
    exactly ``max_gen`` emitted tokens (1 at prefill/admission +
    max_gen - 1 decode steps; no EOS).  Token i of request rid is the
    pure function ``rid * _TOKEN_BASE + i`` — the same shape of contract
    the real engine's greedy row-independent decode satisfies — so a
    request reclaimed by a HOST_DOWN regenerates the bit-identical
    stream on re-admission and the chaos properties can assert token
    equality on the model-free sim too.  With a ``FailPlan``, prefill
    mirrors the pool's retry loop via the shared pure predicate
    ``FailPlan.prefill_rejects``."""

    _TOKEN_BASE = 100_000

    def __init__(self, failpoints: Optional[FailPlan] = None):
        self.failpoints = failpoints if failpoints else None

    def _tok(self, req):
        return req.rid * self._TOKEN_BASE + len(req.tokens)

    def prefill(self, reqs):
        out = []
        for r in reqs:
            if (self.failpoints is not None
                    and self.failpoints.prefill_rejects(
                        r.rid, PREFILL_MAX_ATTEMPTS)):
                out.append(None)
            else:
                out.append(self._tok(r))
        return out

    def decode(self, active):
        return {gslot: self._tok(req) for gslot, req in active.items()}


def simulate_sharded_schedule(per_host: List[List[Request]],
                              slots_per_host: int, gossip_delay: int = 1,
                              *, transport: Optional[Transport] = None,
                              compact_threshold: Optional[float] = None,
                              failpoints: Optional[FailPlan] = None,
                              admission_policy: Optional[AdmissionPolicy]
                              = None,
                              ) -> Tuple[ShardedScheduler, ServeStats]:
    """Model-free replay of the sharded engine's schedule — the SAME
    ``run_schedule`` loop over placeholder tokens, so the engine's event
    log must match this one exactly, COMPACT / reclaim / reject events
    included (asserted by tests/test_serving_multihost.py).
    Deterministic integers only: bench_serving.py commits its outputs as
    a CI baseline.  ``failpoints`` replays a failure schedule against
    the placeholders — same kills, same requeues, same rejects as the
    engine run with the same plan."""
    sched = ShardedScheduler(len(per_host), slots_per_host, gossip_delay,
                             transport=transport,
                             compact_threshold=compact_threshold,
                             failpoints=failpoints,
                             admission_policy=admission_policy)
    sched.push_workloads(per_host)
    stats = run_schedule(sched, _SimClient(failpoints))
    return sched, stats
