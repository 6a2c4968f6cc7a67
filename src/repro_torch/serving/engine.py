"""Slot-based continuous-batching serving engine.

``run_slot_loop`` is THE continuous-batching serve loop: a fixed pool of
slots, host-side admission/retirement per decode step
(serving/scheduler.py), freed slots refilled from the queue every step, and
ONE decode over the whole pool per step.  What a slot holds and what a
decode step computes live in a ``SlotProgram``: the token-LM program
below (``LMSlotProgram``: a per-slot cache pool, KV for attention layers
and conv + SSM state for Mamba layers, every slot at its own position) and the retrieval program (serving/retrieval.py).  Prefill goes
through a ``PrefillPool`` of ``PrefillWorker``s with
retry-on-another-worker.

``Engine`` serves LM requests: ``run`` continuously, ``run_static`` as the
static-batching A/B baseline over the same steps — groups of n_slots start
together and drain until the longest request finishes.  A request's
tokens are the same on both paths where every decode op is
row-independent (dense and SSM layers; prefill is B = 1 at the exact
prompt length).  An MoE layer is not: the slots' tokens, dead slots'
among them, share each expert's capacity, so which copies are dropped
depends on the pool, as in the reference.  The data-axis-sharded pool is
serving/sharded_pool.py's ``ShardedEngine``.

Time is counted in decode steps (deterministic); wall-clock is recorded
but never asserted on.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models import io as io_lib
from repro_torch.models import transformer as tf
from repro_torch.serving import admission as admission_lib
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.failpoints import FailPlan, PREFILL_MAX_ATTEMPTS
from repro_torch.serving.scheduler import (Request, RequestQueue, Scheduler,
                                           ServeStats)


class PrefillFault(RuntimeError):
    """Injected prefill failure (FailPlan ``fail_prefill``) — raised at
    the same point a real worker crash would surface."""


def assert_request_fits(req: Request, max_len: int) -> None:
    """The one pool-capacity precondition, shared by every admission path
    (continuous, static, sharded)."""
    assert req.prompt_len + req.max_gen <= max_len, (
        f"request {req.rid}: prompt {req.prompt_len} + max_gen "
        f"{req.max_gen} exceeds pool max_len {max_len}")


def assert_kind(requests, kind: str, engine: str) -> None:
    """Engines serve exactly one request kind; a mixed workload is a
    routing bug upstream, not something to half-serve."""
    for r in requests:
        if r.kind != kind:
            raise NotImplementedError(
                f"request {r.rid}: kind={r.kind!r} — {engine} serves "
                f"kind={kind!r} only; oneshot retrieval requests go "
                "through serving/retrieval.RetrievalEngine and LM "
                "requests through serving/engine.Engine (DESIGN.md §11)")


class SlotProgram:
    """Arch-agnostic per-slot program: WHAT one slot computes, decoupled
    from WHEN the engine/scheduler runs it (the ROADMAP "continuous
    batching for every architecture" refactor; DESIGN.md §11–12).

    The protocol has two halves:

      * **prefill half** — ``prefill`` turns a request into the payload
        its slot will hold: (caches, first_token) for an autoregressive
        LM program, a (m,) logits row (and no first token) for the
        one-shot retrieval program in serving/retrieval.py.  This is the
        half ``PrefillWorker``/``PrefillPool`` run, possibly on their own
        device — a prefill-only program never builds decode state.
      * **decode half** — the program OWNS its slot-pool state and the
        callables that advance it.  ``init_state`` allocates the
        device-resident pool; ``insert`` consumes a prefill payload into
        a slot (returning whether the slot went live); ``step`` runs ONE
        decode over the whole pool and returns host-side outputs;
        ``emit`` writes one slot's outputs into its request (returning
        whether the slot retires).  ``run_slot_loop`` below drives any
        program through the Scheduler/RequestQueue machinery.

    ``kind`` names the Request.kind the program serves; ``oneshot``
    programs take exactly one recover step after prefill and retire.
    """

    kind = "lm"
    oneshot = False
    engine_label = "a slot-program engine"

    # -- prefill half --------------------------------------------------
    def prefill(self, params, req: Request, device=None):
        raise NotImplementedError

    # -- decode half ---------------------------------------------------
    def check_admit(self, req: Request) -> None:
        """Per-request capacity precondition, asserted at admission."""
        raise NotImplementedError

    def init_state(self, n_slots: int):
        """Allocate the program's device-resident slot-pool state."""
        raise NotImplementedError

    def reset_slots(self, state) -> None:
        """Reset per-slot occupancy for a fresh static group (persistent
        pool buffers survive; only the who-is-live state clears)."""
        raise NotImplementedError

    def insert(self, state, req: Request, payload, stats: ServeStats
               ) -> bool:
        """Consume ``payload`` (what ``prefill`` emitted) into
        ``req.slot``; record any prefill-time output on the request.
        Returns True if the slot is now live (needs decode steps),
        False if the request finished at prefill time."""
        raise NotImplementedError

    def step(self, params, state):
        """ONE decode step over the whole pool; advances
        ``state`` in place and returns host-side outputs for ``emit``."""
        raise NotImplementedError

    def emit(self, state, req: Request, slot: int, out,
             stats: ServeStats) -> bool:
        """Write slot ``slot``'s share of ``out`` into ``req``.
        Returns True if the slot retires (the loop releases it)."""
        raise NotImplementedError

    def set_stage(self, stage: int) -> None:
        """Degrade-ladder hook (DESIGN.md §14): swap to ``stage``'s
        PRE-BUILT decode callable — a dict lookup.
        Programs built without an ``admission_policy`` serve stage 0
        only; asking them to degrade is a wiring bug, not a fallback."""
        if stage != admission_lib.STAGE_NORMAL:
            raise RuntimeError(
                f"{self.engine_label} was built without an "
                f"admission_policy — degrade stage {stage} has no "
                "pre-built decode callable (DESIGN.md §14: stage "
                "decodes are built up front)")


def build_stage_decodes(stage0, topk: int,
                        policy: Optional[AdmissionPolicy], make):
    """stage -> PRE-BUILT decode callable (DESIGN.md §14).

    ``stage0`` is the already-built full-width callable; ``make(k)``
    builds the width-``k`` variant.  Stages whose ``admission.stage_topk``
    width equals an already-built stage share its callable, and a
    DEGRADE/RESTORE transition is a dict lookup."""
    stages = {admission_lib.STAGE_NORMAL: stage0}
    if policy is None:
        return stages
    by_width = {topk: stage0}
    for st in range(1, policy.max_stage + 1):
        k = admission_lib.stage_topk(topk, st, policy)
        if k not in by_width:
            by_width[k] = make(k)
        stages[st] = by_width[k]
    return stages


@dataclasses.dataclass
class _LMState:
    """Device-resident LM slot-pool state: the per-layer cache pool
    plus the (tokens, pos, active) slot vectors, which stay on the device
    for the whole run (the host writes them only on admit/retire)."""
    caches: list
    tokens: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor


class LMSlotProgram(SlotProgram):
    """The autoregressive token-LM program: prefill + first-token Eq. 3
    recovery, and the decode half — slot KV-cache pool on ``device``, one
    pool decode step, device-side (tokens, pos, active) advance.  Prefill
    is always B = 1 at the exact prompt length, so a request's tokens do
    not depend on its pool."""

    kind = "lm"
    oneshot = False
    engine_label = "the token-LM engine"

    def __init__(self, cfg: ModelConfig, *, topk: int, device,
                 n_slots: int, max_len: int,
                 eos_id: Optional[int] = None,
                 admission_policy: Optional[AdmissionPolicy] = None):
        self.cfg = cfg
        self.topk = topk
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self._prefill = steps_lib.make_prefill_step(cfg)
        if not (n_slots >= 1 and max_len >= 2):
            raise ValueError(f"need n_slots >= 1 and max_len >= 2, got "
                             f"{n_slots} and {max_len}")
        self._decode = steps_lib.make_slot_decode_step(cfg, topk,
                                                       self.device)
        # degrade ladder (DESIGN.md §14): one pre-built decode per stage
        # width; narrowing the served top-k never changes the emitted
        # token — the next token is the top-1 id, invariant under k
        self._stage = admission_lib.STAGE_NORMAL
        self._stage_decodes = build_stage_decodes(
            self._decode, topk, admission_policy,
            lambda k: steps_lib.make_slot_decode_step(cfg, k, self.device))

    # -- prefill half --------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, req: Request, device=None):
        """req -> (caches at prompt length, greedy first token id)."""
        dev = self.device if device is None else device
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=dev)[None, :]
        pre = self._prefill(params, prompt)
        _, ids = io_lib.recover_topk(self.cfg, pre["last_logits"],
                                     topk=self.topk)
        return pre["caches"], int(ids[0, 0])

    # -- decode half ---------------------------------------------------
    def check_admit(self, req: Request) -> None:
        assert_request_fits(req, self.max_len)

    def stopped(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return len(req.tokens) >= req.max_gen

    def init_state(self, n_slots: int) -> _LMState:
        if n_slots != self.n_slots:
            raise ValueError(f"pool of {n_slots} slots, program built for "
                             f"{self.n_slots}")
        dev = self.device
        return _LMState(
            caches=tf.init_lm_cache(self.cfg, n_slots, self.max_len,
                                    dtype=getattr(torch, self.cfg.dtype),
                                    device=dev),
            tokens=torch.zeros((n_slots, 1), dtype=torch.int64, device=dev),
            pos=torch.zeros((n_slots,), dtype=torch.int64, device=dev),
            active=torch.zeros((n_slots,), dtype=torch.bool, device=dev))

    def reset_slots(self, state: _LMState) -> None:
        state.tokens.zero_()
        state.pos.zero_()
        state.active.zero_()

    def insert(self, state: _LMState, req: Request, payload,
               stats: ServeStats) -> bool:
        small, first = payload
        steps_lib.insert_cache_slot(state.caches, small, req.slot)
        req.tokens.append(first)
        stats.tokens_out += 1
        if self.stopped(req, first):
            return False
        # admit event: the only host-to-device write of the slot state
        state.tokens[req.slot, 0] = first
        state.pos[req.slot] = req.prompt_len
        state.active[req.slot] = True
        return True

    def set_stage(self, stage: int) -> None:
        if stage not in self._stage_decodes:
            raise RuntimeError(
                f"{self.engine_label}: degrade stage {stage} was not "
                "pre-built — construct the program with the run's "
                "admission_policy (DESIGN.md §14)")
        self._stage = stage

    def step(self, params, state: _LMState):
        out = self._stage_decodes[self._stage](
            params, state.tokens, state.caches, state.pos, state.active)
        # tokens and pos advance on the device from the step's own
        # outputs; the download of the new tokens is the one transfer the
        # host-side retirement decision needs
        nxt = out["topk_ids"][:, :1].to(state.tokens.dtype)
        state.tokens = torch.where(state.active[:, None], nxt, state.tokens)
        state.pos = state.pos + state.active.to(state.pos.dtype)
        return out["topk_ids"][:, 0].cpu().numpy()

    def emit(self, state: _LMState, req: Request, slot: int, out,
             stats: ServeStats) -> bool:
        tok = int(out[slot])
        req.tokens.append(tok)
        stats.tokens_out += 1
        if self.stopped(req, tok):
            state.active[slot] = False
            return True
        return False


class PrefillWorker:
    """Disaggregated prefill: owns a ``SlotProgram``'s prefill half,
    optionally pinned to a dedicated device (its own copy of the params
    lives there).

    The worker emits whatever its program's prefill emits — (logits_row,
    None) for the one-shot retrieval program; the caller inserts the
    payload into its decode pool.
    """

    def __init__(self, params, *, program: SlotProgram, device=None):
        self.device = device
        if device is not None:
            params = copy.deepcopy(params).to(device)
        self.params = params
        self.program = program

    def prefill(self, req: Request):
        """req -> the program's slot payload (see class doc)."""
        return self.program.prefill(self.params, req, device=self.device)


class PrefillPool:
    """Prefill *pool*: a FIFO scheduler over N single-slice
    ``PrefillWorker``s (DESIGN.md §9, ROADMAP follow-up b).

    A burst of same-step arrivals used to serialize on the single prefill
    worker — the whole burst head-of-line blocked admission for the
    duration of N prefills.  The pool dispatches queued jobs FIFO to the
    earliest-available worker (a deterministic virtual-time model: each
    worker's clock advances by the job's prompt length), so with W
    workers a burst drains ~W-times faster in prefill-time while the
    step-clock schedule — and therefore every committed bench row and
    every recovered token — is unchanged for ANY W (prefill is B=1
    exact-length on identical replicated weights on every worker; the
    dispatch order is the admission order).

    In this single-process simulation jobs still *execute* sequentially;
    ``stats`` records the dispatch the pool would overlap — per-worker
    job counts, max queue depth, and the summed virtual queue wait
    (``wait_units``, in prompt-length units) that tests assert shrinks as
    workers are added.  A real deployment runs each worker's
    callables on its own device asynchronously.

    A worker raising mid-prefill no longer loses the request (it used to
    escape the pool and strand the slot): the job retries on the next
    worker, up to ``PREFILL_MAX_ATTEMPTS`` attempts, then surfaces as a
    ``None`` result — the scheduler turns that into a REJECT event
    instead of hanging.  Injected faults (``FailPlan.fail_prefill``)
    raise at the same point a real crash would.
    """

    def __init__(self, params, *, program: SlotProgram, n_workers: int = 1,
                 devices=None, failpoints: Optional[FailPlan] = None):
        assert n_workers >= 1
        if devices is None:
            devices = [None]
        # one PrefillWorker per DISTINCT device: pool slots landing on the
        # same device share it (and its copy of the params).
        by_device = {}
        self.workers = []
        for i in range(n_workers):
            dev = devices[i % len(devices)]
            if dev not in by_device:
                by_device[dev] = PrefillWorker(params, program=program,
                                               device=dev)
            self.workers.append(by_device[dev])
        self.n_workers = n_workers
        self.failpoints = failpoints if failpoints else None
        self._fifo: List[Request] = []
        self._busy = [0.0] * n_workers     # virtual per-worker clock
        self.stats = {"jobs": 0, "max_queue_depth": 0, "wait_units": 0.0,
                      "per_worker": [0] * n_workers, "retries": 0,
                      "rejects": 0}

    def submit(self, req: Request) -> None:
        self._fifo.append(req)
        self.stats["max_queue_depth"] = max(self.stats["max_queue_depth"],
                                            len(self._fifo))

    def _attempt(self, req: Request, w0: int,
                 base: float) -> Optional[Tuple[object, int]]:
        """Run ``req``'s prefill with retry-on-another-worker: attempt k
        lands on worker (w0 + k) % n_workers, so a crashed worker's jobs
        migrate off it.  Accounting (virtual clocks, per-worker counts)
        records only the attempt that completed — the failure-free path
        is step-for-step identical to the pre-retry pool.  Returns None
        once the attempt cap is exhausted (the REJECT path).  Only the
        injected ``PrefillFault`` is retried: any other error (a CUDA
        error, out of memory) propagates."""
        for attempt in range(PREFILL_MAX_ATTEMPTS):
            w = (w0 + attempt) % self.n_workers
            try:
                if (self.failpoints is not None
                        and self.failpoints.prefill_attempt_fails(
                            req.rid, attempt)):
                    raise PrefillFault(
                        f"injected prefill fault: rid {req.rid} "
                        f"attempt {attempt} on worker {w}")
                res = self.workers[w].prefill(req)
            except PrefillFault:
                self.stats["retries"] += 1
                continue
            self.stats["wait_units"] += self._busy[w] - base
            self._busy[w] += float(req.prompt_len)
            self.stats["per_worker"][w] += 1
            self.stats["jobs"] += 1
            return res
        self.stats["rejects"] += 1
        return None

    def drain(self) -> List[Optional[Tuple[object, int]]]:
        """Dispatch every queued job FIFO to the earliest-available
        worker; returns (caches, first_token) per job in submit order —
        None for a job whose every attempt failed."""
        out = []
        base = max(self._busy) if self._fifo else 0.0
        # a fresh burst starts all workers at the same origin: only the
        # waits created by THIS burst count
        self._busy = [base] * self.n_workers
        for req in self._fifo:
            w = min(range(self.n_workers), key=lambda i: (self._busy[i], i))
            out.append(self._attempt(req, w, base))
        self._fifo = []
        return out

    def prefill_all(self, reqs: List[Request]
                    ) -> List[Optional[Tuple[object, int]]]:
        for r in reqs:
            self.submit(r)
        return self.drain()


def run_slot_loop(program: SlotProgram, params, prefill_pool: PrefillPool,
                  requests: List[Request], n_slots: int,
                  state=None, failpoints: Optional[FailPlan] = None,
                  admission_policy: Optional[AdmissionPolicy] = None,
                  ) -> Tuple[Dict[int, Request], ServeStats,
                             Scheduler, object]:
    """THE continuous-batching serve loop, generic over a SlotProgram.

    Admission, prefill dispatch, rejection, per-step stats, clock
    fast-forward and retirement are identical for every program; what a
    slot holds (KV caches vs a logits row), what a decode step computes,
    and what retires a slot (stop condition vs oneshot) live in the
    program.  The LM engine's ``run`` and the retrieval engine's ``run``
    are both thin wrappers over this function — tokens and top-k ids are
    bit-identical to the pre-refactor per-engine loops (asserted by
    tests/test_serving.py + tests/test_retrieval.py and the
    BENCH_serving.json --check gate).

    ``failpoints`` injects overload (DESIGN.md §14) exactly as the
    sharded path does: ``surge:R@S`` compresses the queue's arrival
    clock, ``slow_decode:N@S`` makes each decode step cost N clock
    ticks.  ``admission_policy`` enables the overload pass — shed
    expired / over-bound queued requests, then step the degrade ladder
    — evaluated once per clock tick BEFORE admission, identical in shape
    to ``ShardedScheduler._apply_policy``.  Because this loop serves any
    SlotProgram, the policy lands on the LM and retrieval engines at
    once.

    Mutates and returns the requests; also returns the Scheduler (slot
    event log) and the program state (e.g. the retrieval program's
    accumulated modeled bytes).
    """
    assert_kind(requests, program.kind, program.engine_label)
    fp = failpoints if failpoints else None
    queue = RequestQueue(
        requests,
        arrival_key=(None if fp is None else
                     (lambda r: fp.effective_arrival(r.arrival_step))))
    sched = Scheduler(n_slots)
    stats = ServeStats()
    policy = admission_policy
    window = (deque(maxlen=policy.pressure_window)
              if policy is not None else None)
    stage = admission_lib.STAGE_NORMAL
    policy_stepped = -1
    if state is None:
        state = program.init_state(n_slots)
    now = 0
    t0 = time.perf_counter()

    while len(queue) or sched.n_active:
        if policy is not None and policy_stepped != now:
            # the overload pass, once per clock tick: sheds first, so
            # the pressure sample reflects the bounded queue
            policy_stepped = now
            visible = queue.visible(now)
            sheds = admission_lib.compute_sheds(
                {r.rid: (queue.arrival_of(r), r.home) for r in visible},
                {r.rid: r.deadline_step for r in visible}, now, policy)
            if sheds:
                reasons = dict(sheds)
                for req in queue.remove([rid for rid, _ in sheds]):
                    req.shed = True
                    req.finish_step = now
                    sched.log.shed(now, req.rid, reasons[req.rid],
                                   req.home)
                    stats.sheds += 1
            window.append(admission_lib.pressure(
                len(queue.visible(now)), n_slots))
            new = admission_lib.plan_stage(window, policy, stage)
            if new != stage:
                sched.log.degrade(now, stage, new)
                stats.degrades += 1
                program.set_stage(new)
                stage = new
        admitted = sched.admit(queue, now)
        for req in admitted:
            program.check_admit(req)
        # the whole admission burst goes through the prefill pool at
        # once: FIFO dispatch over the workers, results in admission
        # order (token- and schedule-identical for any worker count)
        prefilled = (prefill_pool.prefill_all(admitted)
                     if admitted else [])
        for req, res in zip(admitted, prefilled):
            if res is None:
                # every prefill attempt failed: REJECT — free the slot
                # instead of hanging the pool on a request that can
                # never start
                stats.rejects += 1
                sched.reject(req.slot, now)
                continue
            stats.prefills += 1
            if not program.insert(state, req, res, stats):
                # prefill-time retirement (max_gen==1 / first-token EOS)
                sched.release(req.slot, now)

        if not sched.n_active:
            nxt = queue.next_arrival()
            if nxt is None:
                break
            if nxt <= now:
                # a slot was freed at `now` (prefill-time retirement or
                # reject) while a request is already ready: re-admit
                # NOW, no clock tick
                continue
            # empty pool: fast-forward the clock to the next arrival
            stats.idle_steps += nxt - now
            now = nxt
            continue

        out = program.step(params, state)
        stats.decode_steps += 1
        stats.slot_steps_total += n_slots
        stats.slot_steps_active += sched.n_active
        # an injected slow_decode makes each decode step cost N clock
        # ticks — arrivals pile up, driving the pressure signal
        now += fp.decode_cost(now) if fp is not None else 1
        for slot, req in list(sched.active.items()):
            if program.emit(state, req, slot, out, stats):
                sched.release(slot, now)

    if stage != admission_lib.STAGE_NORMAL:
        # post-run data-plane reset (like reset_slots): the program is
        # reused across runs and must start the next one undegraded
        program.set_stage(admission_lib.STAGE_NORMAL)
    stats.wall_s = time.perf_counter() - t0
    return {r.rid: r for r in requests}, stats, sched, state


class Engine:
    """Continuous-batching engine over a fixed slot pool of a decoder LM
    (dense, MoE, SSM or hybrid).

    One Engine owns ONE ``LMSlotProgram``; ``run`` (continuous, via
    ``run_slot_loop``) and ``run_static`` (A/B baseline) share it, so any
    numeric difference between the two paths would be a scheduling bug.
    The pool lives on the params' device.
    """

    @staticmethod
    def supports(cfg: ModelConfig) -> bool:
        """Continuous batching serves decoder-only token LMs; the
        encoder-decoder (``audio``) and frontend-stub (``vlm``) archs
        carry non-token prefill inputs the engine does not schedule, and
        serve by the whole-batch ``launch/serve.run`` path.  The one place
        of that rule (the CLI checks it before building a model)."""
        return cfg.family != "audio" and cfg.frontend == "none"

    def __init__(self, cfg: ModelConfig, params: tf.TransformerLM, *,
                 n_slots: int, max_len: int, topk: int = 8,
                 eos_id: Optional[int] = None, prefill_workers: int = 1,
                 failpoints: Optional[FailPlan] = None,
                 admission_policy: Optional[AdmissionPolicy] = None):
        if not Engine.supports(cfg):
            raise NotImplementedError(
                f"{cfg.name}: continuous batching serves decoder-only "
                "token LMs (see Engine.supports); use the static "
                "launch/serve.py path")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.failpoints = failpoints if failpoints else None
        self.policy = admission_policy
        self.device = next(params.parameters()).device
        steps_lib.warm_bloom_caches(cfg, params)
        self.program = LMSlotProgram(cfg, topk=topk, device=self.device,
                                     n_slots=n_slots, max_len=max_len,
                                     eos_id=eos_id,
                                     admission_policy=admission_policy)
        self.prefill_pool = PrefillPool(params, program=self.program,
                                        n_workers=prefill_workers,
                                        failpoints=self.failpoints)

    def run(self, requests: List[Request]
            ) -> Tuple[Dict[int, Request], ServeStats]:
        """Continuous batching: admit into freed slots every step, retire
        on per-slot stop conditions.  Mutates and returns the requests."""
        results, stats, sched, _ = run_slot_loop(
            self.program, self.params, self.prefill_pool, requests,
            self.n_slots, failpoints=self.failpoints,
            admission_policy=self.policy)
        self._sched = sched          # exposed for the simulation tests
        return results, stats

    def run_static(self, requests: List[Request]
                   ) -> Tuple[Dict[int, Request], ServeStats]:
        """Static-batching A/B baseline over the SAME steps.

        Requests are grouped n_slots at a time in arrival order; a group
        starts only when its last member has arrived and drains until its
        longest request stops — retired slots keep burning decode steps,
        which is exactly the utilization gap continuous batching closes.
        """
        assert_kind(requests, "lm", "the token-LM engine")
        prog = self.program
        stats = ServeStats()
        reqs = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
        state = prog.init_state(self.n_slots)
        now = 0
        t0 = time.perf_counter()

        for g in range(0, len(reqs), self.n_slots):
            group = reqs[g:g + self.n_slots]
            start = max([now] + [r.arrival_step for r in group])
            stats.idle_steps += start - now
            now = start

            prog.reset_slots(state)
            # host-side mirror of the active mask: scheduling decisions
            # (group drained? which slots still collect?) stay host-side
            collecting = np.zeros((self.n_slots,), bool)
            for slot, req in enumerate(group):
                req.slot = slot
                req.admitted_step = now
                prog.check_admit(req)
                res, = self.prefill_pool.prefill_all([req])
                if res is None:
                    raise RuntimeError(
                        f"request {req.rid}: prefill permanently failed on "
                        "the static path (no REJECT protocol there — serve "
                        "it via the continuous engine)")
                stats.prefills += 1
                if prog.insert(state, req, res, stats):
                    collecting[slot] = True
                else:
                    req.finish_step = now

            while collecting.any():
                out = prog.step(self.params, state)
                stats.decode_steps += 1
                # static batching burns every slot of the pool per step
                stats.slot_steps_total += self.n_slots
                stats.slot_steps_active += int(collecting.sum())
                now += 1
                for slot, req in enumerate(group):
                    if not collecting[slot]:
                        continue
                    if prog.emit(state, req, slot, out, stats):
                        req.finish_step = now
                        collecting[slot] = False

        stats.wall_s = time.perf_counter() - t0
        return {r.rid: r for r in requests}, stats


def mean_latency(results: Dict[int, Request]) -> float:
    """Mean (finish - arrival) in decode steps across completed requests.
    Shed requests are terminal but never served — no latency to count."""
    done = [r for r in results.values() if r.done and not r.shed]
    if not done:
        return 0.0
    return float(np.mean([r.finish_step - r.arrival_step for r in done]))
