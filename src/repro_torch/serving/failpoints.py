"""Seeded, deterministic fault injection for the serving + training stack.

One registry (`FailPlan`) describes every fault a run will experience, as
pure data: which host dies at which step, which transport round hangs,
which prefill attempts fail, which replica reports a corrupted state
digest, at which train step the driver raises.  The plan is consulted by
the scheduler (host kills), both transports (round hangs, digest
corruption, arrival delays), the prefill pool (per-attempt worker
failures), and the train driver (induced crash) — so the engine run, the
model-free simulation, the bench row, and the CI chaos job all replay the
IDENTICAL failure schedule from one committed spec string.

The module is dependency-free (no jax, no numpy at import time) so the
train driver can import it without touching the serving stack.

Spec grammar — comma-separated failpoints, order irrelevant:

    kill_host:H@S        host H dies physically at step S (its slots stop
                         decoding at S; a HOST_DOWN delta gossips out and
                         every replica reclaims the range at visibility)
    delay_arrivals:D@S   ARRIVE deltas produced at step S become visible
                         D steps later than the transport's base delay
    hang_round:D@S       the transport round at step S takes D virtual
                         time units; rounds past the transport deadline
                         raise TransportTimeout instead of blocking
    fail_prefill:R:N     request R's first N prefill attempts raise; the
                         pool retries on other workers and REJECTs after
                         PREFILL_MAX_ATTEMPTS
    corrupt_digest:H@S   host H's replica reports a flipped state digest
                         in the round at step S (models silent divergence;
                         both transports must raise ReplicaDivergence)
    train_fault@S        the training loop raises at step S (the crash
                         the checkpoint/resume path must survive)
    surge:R@S            arrival-rate multiplier: arrivals scheduled at or
                         after step S are compressed toward S by factor R
                         (eff = S + (a - S) // R) — the open-loop traffic
                         spike that overwhelms the pool (DESIGN.md §14)
    slow_decode:N@S      from step S onward each decode step costs N clock
                         ticks instead of 1 (models a degraded accelerator
                         or noisy neighbour; arrivals pile up during the
                         slow steps, driving the pressure signal)

Delays apply to ARRIVE deltas only: a RELEASE or HOST_DOWN delta always
travels at the transport's base delay.  This is load-bearing — see
DESIGN.md §10 for why selectively delaying completion reports past a
host death would need an acknowledged-completion protocol to stay safe.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

# Shared by the real PrefillPool and the model-free sim client so both
# compute the same succeeds/rejects outcome from one plan.
PREFILL_MAX_ATTEMPTS = 3

KILL_HOST = "kill_host"
DELAY_ARRIVALS = "delay_arrivals"
HANG_ROUND = "hang_round"
FAIL_PREFILL = "fail_prefill"
CORRUPT_DIGEST = "corrupt_digest"
TRAIN_FAULT = "train_fault"
SURGE = "surge"
SLOW_DECODE = "slow_decode"

_KINDS = (KILL_HOST, DELAY_ARRIVALS, HANG_ROUND, FAIL_PREFILL,
          CORRUPT_DIGEST, TRAIN_FAULT, SURGE, SLOW_DECODE)


@dataclasses.dataclass(frozen=True)
class Failpoint:
    """One injected fault.  Field meaning depends on `kind`:

    kill_host:       host=victim,   step=death step
    delay_arrivals:  delay=extra,   step=production step it applies to
    hang_round:      delay=virtual round duration, step=the hung round
    fail_prefill:    rid=victim,    count=number of failing attempts
    corrupt_digest:  host=replica,  step=the corrupted round
    train_fault:     step=train step at which the driver raises
    surge:           count=rate multiplier, step=first compressed step
    slow_decode:     delay=ticks per decode step, step=first slow step
    """
    kind: str
    step: int = -1
    host: int = -1
    rid: int = -1
    count: int = 1
    delay: int = 0

    def spec(self) -> str:
        if self.kind == KILL_HOST:
            return f"{KILL_HOST}:{self.host}@{self.step}"
        if self.kind == DELAY_ARRIVALS:
            return f"{DELAY_ARRIVALS}:{self.delay}@{self.step}"
        if self.kind == HANG_ROUND:
            return f"{HANG_ROUND}:{self.delay}@{self.step}"
        if self.kind == FAIL_PREFILL:
            return f"{FAIL_PREFILL}:{self.rid}:{self.count}"
        if self.kind == CORRUPT_DIGEST:
            return f"{CORRUPT_DIGEST}:{self.host}@{self.step}"
        if self.kind == TRAIN_FAULT:
            return f"{TRAIN_FAULT}@{self.step}"
        if self.kind == SURGE:
            return f"{SURGE}:{self.count}@{self.step}"
        if self.kind == SLOW_DECODE:
            return f"{SLOW_DECODE}:{self.delay}@{self.step}"
        raise ValueError(f"unknown failpoint kind {self.kind!r}")


def _parse_one(tok: str) -> Failpoint:
    tok = tok.strip()
    if not tok:
        raise ValueError("empty failpoint token")
    head, _, tail = tok.partition(":")
    if head.partition("@")[0] == TRAIN_FAULT:
        # train_fault@S has no ':' segment
        head, _, at = tok.partition("@")
        if not at:
            raise ValueError(f"bad failpoint {tok!r}")
        return Failpoint(TRAIN_FAULT, step=int(at))
    if head not in _KINDS:
        raise ValueError(f"unknown failpoint kind {head!r} in {tok!r}")
    if head == FAIL_PREFILL:
        rid_s, _, n_s = tail.partition(":")
        return Failpoint(FAIL_PREFILL, rid=int(rid_s),
                         count=int(n_s) if n_s else 1)
    val_s, _, at_s = tail.partition("@")
    if not at_s:
        raise ValueError(f"failpoint {tok!r} needs an @step")
    val, step = int(val_s), int(at_s)
    if head == KILL_HOST:
        return Failpoint(KILL_HOST, step=step, host=val)
    if head == DELAY_ARRIVALS:
        return Failpoint(DELAY_ARRIVALS, step=step, delay=val)
    if head == HANG_ROUND:
        return Failpoint(HANG_ROUND, step=step, delay=val)
    if head == SURGE:
        if val < 2:
            raise ValueError(
                f"surge factor must be >= 2, got {val} in {tok!r}")
        return Failpoint(SURGE, step=step, count=val)
    if head == SLOW_DECODE:
        if val < 2:
            raise ValueError(
                f"slow_decode ticks must be >= 2, got {val} in {tok!r}")
        return Failpoint(SLOW_DECODE, step=step, delay=val)
    return Failpoint(CORRUPT_DIGEST, step=step, host=val)


@dataclasses.dataclass(frozen=True)
class FailPlan:
    """An immutable failure schedule; query methods are pure functions of
    (plan, step/rid/attempt), so any component consulting the same plan
    at the same point computes the same fault — the determinism the chaos
    tests lean on."""
    points: Tuple[Failpoint, ...] = ()

    # -- construction --------------------------------------------------
    @classmethod
    def parse(cls, spec: Optional[str]) -> "FailPlan":
        """Parse a comma-separated spec string; '' / None -> empty plan."""
        if not spec:
            return cls(())
        return cls(tuple(_parse_one(t) for t in spec.split(",") if
                         t.strip()))

    @classmethod
    def single_kill(cls, host: int, step: int) -> "FailPlan":
        return cls((Failpoint(KILL_HOST, step=step, host=host),))

    def merge(self, other: "FailPlan") -> "FailPlan":
        """Union of two plans (duplicates kept — every query sums or
        any()s over points, so repeats are harmless)."""
        return FailPlan(self.points + other.points)

    def spec(self) -> str:
        return ",".join(p.spec() for p in self.points)

    def __str__(self) -> str:
        return self.spec()

    def __bool__(self) -> bool:
        return bool(self.points)

    # -- queries -------------------------------------------------------
    def kills_at(self, step: int) -> List[int]:
        """Hosts that die at exactly `step`, in deterministic order."""
        return sorted(p.host for p in self.points
                      if p.kind == KILL_HOST and p.step == step)

    def kill_steps(self) -> List[int]:
        return sorted(p.step for p in self.points if p.kind == KILL_HOST)

    def arrive_extra_delay(self, step: int) -> int:
        """Extra visibility delay for ARRIVE deltas produced at `step`."""
        return sum(p.delay for p in self.points
                   if p.kind == DELAY_ARRIVALS and p.step == step)

    def round_hang(self, step: int) -> int:
        """Virtual duration of the transport round at `step` (0 = fast)."""
        return sum(p.delay for p in self.points
                   if p.kind == HANG_ROUND and p.step == step)

    def prefill_attempt_fails(self, rid: int, attempt: int) -> bool:
        """Does request `rid`'s `attempt`-th prefill attempt raise?"""
        return any(p.kind == FAIL_PREFILL and p.rid == rid
                   and attempt < p.count for p in self.points)

    def prefill_rejects(self, rid: int,
                        max_attempts: int = PREFILL_MAX_ATTEMPTS) -> bool:
        """Pure predicate: will `rid` exhaust every attempt and be
        REJECTed?  The model-free sim uses this to mirror the pool's
        retry loop without running it."""
        return all(self.prefill_attempt_fails(rid, a)
                   for a in range(max_attempts))

    def digest_mask(self, host: int, step: int) -> int:
        """XOR mask applied to `host`'s reported state digest in the
        round at `step`; 0 means the replica reports honestly."""
        hit = any(p.kind == CORRUPT_DIGEST and p.host == host
                  and p.step == step for p in self.points)
        return 0x5A5A5A5A if hit else 0

    def effective_arrival(self, step: int) -> int:
        """Arrival step after every surge compression has been applied.

        Each ``surge:R@S`` pulls arrivals scheduled at or after S toward
        S: ``a -> S + (a - S) // R``.  Surges apply in ascending-S order
        so stacked surges compose deterministically; steps before every
        surge are untouched.  Pure in (plan, step) — the scheduler AND
        the model-free sim both route arrivals through this, so the
        compressed traffic is identical everywhere."""
        for p in sorted(((p.step, p.count) for p in self.points
                         if p.kind == SURGE)):
            s, factor = p
            if step >= s:
                step = s + (step - s) // factor
        return step

    def surge_steps(self) -> List[int]:
        return sorted(p.step for p in self.points if p.kind == SURGE)

    def decode_cost(self, step: int) -> int:
        """Clock ticks one decode step costs at `step` (1 = healthy).
        The largest active ``slow_decode`` wins; slowdowns are permanent
        from their onset step, like kills."""
        costs = [p.delay for p in self.points
                 if p.kind == SLOW_DECODE and step >= p.step]
        return max(costs, default=1)

    def overload_steps(self) -> List[int]:
        """Onset steps of every overload failpoint (surge + slow_decode);
        empty means the plan injects no overload — drills gate their
        verified markers on this, like kill_steps()."""
        return sorted(p.step for p in self.points
                      if p.kind in (SURGE, SLOW_DECODE))

    def train_hook(self) -> Optional[Callable[[int], None]]:
        """A Trainer/driver `fault_hook` raising at the planned step, or
        None if the plan injects no train fault.  The message is part of
        the crash-and-resume contract (tests grep for it)."""
        steps = sorted(p.step for p in self.points
                       if p.kind == TRAIN_FAULT)
        if not steps:
            return None

        def hook(step: int) -> None:
            if step in steps:
                raise RuntimeError(f"induced fault at step {step}")

        return hook

    # -- generation ----------------------------------------------------
    @classmethod
    def sample_kills(cls, seed: int, n_hosts: int, lo: int, hi: int,
                     n_kills: int = 1) -> "FailPlan":
        """Seeded random kill schedule: `n_kills` distinct hosts (always
        leaving at least one survivor) die at steps drawn from [lo, hi).
        Pure python LCG so the plan is identical on every platform."""
        assert 0 < n_kills < n_hosts
        state = (seed * 2654435761 + 97531) & 0xFFFFFFFF
        hosts = list(range(n_hosts))
        points = []
        for _ in range(n_kills):
            state = (state * 1103515245 + 12345) & 0x7FFFFFFF
            h = hosts.pop(state % len(hosts))
            state = (state * 1103515245 + 12345) & 0x7FFFFFFF
            s = lo + state % max(1, hi - lo)
            points.append(Failpoint(KILL_HOST, step=s, host=h))
        return cls(tuple(sorted(points, key=lambda p: (p.step, p.host))))
