"""Data-axis-sharded serving: the data plane of the control/data-plane
split: a slot pool sharded over hosts, transported admission, a
disaggregated prefill pool and slot compaction.

  * **Sharded slot pool.** The pool is ``transformer.init_lm_cache``'s
    per-layer cache dicts with the slot axis first; host h owns rows
    ``[h * sph, (h + 1) * sph)`` (``launch/sharding.slot_pool_pspecs``).
    Inserts (``steps.make_sharded_insert``) and compactions
    (``steps.make_compact_pool``) touch only the owning host's rows, in
    place.  The mesh (``launch/mesh.make_serving_mesh``) is of one of two
    kinds:

      - on ONE device, every host a simulated data shard of one pool (the
        reference simulates N hosts as N CPU devices of one process): one
        decode step runs over all ``n_slots`` rows, as the reference's
        GSPMD step does;
      - over a WORLD of ``n_hosts * model_parallel`` rank processes, one
        rank per (data, model) coordinate: a rank's pool holds only its
        host's ``sph`` rows and, under a ``model`` axis, its share of the
        kv heads, Mamba heads and ``conv_x`` channels.  Every rank runs
        the whole replicated control plane over the whole workload and
        executes only its own host's part: the prefill of its host's
        admissions, on its data shard's model group alone
        (``mesh.model_mesh``: no collective over ``data``, so an MoE
        router's batch collectives are not entered), the insert into its
        rows, its window of a compaction, and the decode of its rows
        (``steps.make_slot_decode_step`` under the mesh: tensor parallel
        over ``model``, an MoE routing the whole pool over ``data``).
        Each decode step's top-1 ids and each admission round's prefill
        outcomes are all-gathered over ``data``, so every rank's control
        plane advances on the same integers.  A killed host's ranks stay
        in the world: their rows go inactive and they keep joining every
        collective.  The params are each rank's shards
        (``train.parallel_state``).

  * **Transported admission.** Scheduling is the replicated state
    machine of serving/control.py driven by
    ``scheduler.ShardedScheduler``: arrival and release deltas travel a
    ``Transport`` (``"sim"``, the in-process gossip; ``"collective"``,
    the fixed-size padded exchange, serving/collective.py: gathered on
    the device on one device, all-gathered over ``data`` across ranks),
    every host computes the same admissions, and each executes only
    those in its own slot range.
  * **Disaggregated prefill pool.** Prefill runs on
    ``engine.PrefillPool`` (FIFO over ``prefill_workers`` workers on the
    mesh's device; across ranks over this host's admissions only); the
    B = 1 caches are inserted into the pool by the sharded insert.
  * **Slot compaction.** With ``compact_threshold`` set, the control
    plane densifies fragmented host shards (``control.plan_compaction``)
    and this engine applies the remap to the cache pool and to the
    host-side token / position / active arrays; dead and retired rows go
    to the decode-top-k kernel's row-skipping grid through ``active``.
  * **One decode step object and one pool storage.** The stage-0 step
    (``steps.make_slot_decode_step``) is built once, at construction,
    and every run decodes with it (the reference's "one compiled decode
    step survives the matrix"; the degrade ladder's narrower steps are
    pre-built too).  The pool is allocated once; every leaf keeps its
    storage (``data_ptr()``) across runs, inserts, decodes, compactions
    and host kills, checked after each.  ``decode_steps_built`` and
    ``storage_checks`` expose both, on each rank.

Per-request tokens equal the single-host engine's and solo static
serving's, across both transports, with compaction on or off and on
either kind of mesh, where every decode op is row-independent: prefill
is B = 1 at exact prompt length everywhere, and a compaction merely
permutes rows.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.launch import sharding as sharding_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import model_mesh
from repro_torch.models import transformer as tf
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.collective import make_device_gather
from repro_torch.serving.control import (CollectiveTransport, SimTransport,
                                         Transport)
from repro_torch.serving.engine import (Engine, LMSlotProgram, PrefillPool,
                                        ServeStats)
from repro_torch.serving.scheduler import (Request, ScheduleClient,
                                           ShardedScheduler, run_schedule)

# delta rows per host per exchange round of the collective transport
# (plus one digest row); a round's buffer never changes shape
COLLECTIVE_CAPACITY = 8


class _PoolClient(ScheduleClient):
    """The real data plane behind ``run_schedule``: prefill-pool dispatch,
    sharded cache inserts, the pool decode step, and the compaction
    remap.  The model-free ``_SimClient`` fills the same hooks with
    placeholders; sharing the loop is what makes the engine's event log
    equal the simulation's integer for integer."""

    def __init__(self, engine: "ShardedEngine", sched: ShardedScheduler):
        self.e = engine
        self.sched = sched
        self.stage = 0        # current degrade stage
        self.tokens = np.zeros((engine.n_slots, 1), np.int64)
        self.pos = np.zeros((engine.n_slots,), np.int64)
        self.active = np.zeros((engine.n_slots,), bool)
        self.caches = engine._fresh_pool()

    def prefill(self, reqs: List[Request]) -> List[Optional[int]]:
        for req in reqs:
            engine_lib.assert_request_fits(req, self.e.max_len)
        # each host executes the admissions that land in its own shard
        executor = {r.rid: shard.host for shard in self.sched.hosts
                    for r in reqs if shard.owns(r.slot)}
        mine = [r for r in reqs if self.e.host is None
                or executor[r.rid] == self.e.host]
        firsts = {}
        for req, res in zip(mine, self.e.prefill_pool.prefill_all(mine)):
            if res is None:
                # attempt cap exhausted: no caches to insert; the loop
                # REJECTs the slot, which stays inactive
                firsts[req.rid] = None
                continue
            small, first = res
            self.caches = self.e._insert(self.caches, small, req.slot,
                                         executor[req.rid])
            firsts[req.rid] = first
        self.e._check_storage(self.caches)
        if self.e.host is not None:
            firsts = self.e._owners_outcomes(reqs, executor, firsts)
        return [firsts[r.rid] for r in reqs]

    def stopped(self, req: Request, tok: int) -> bool:
        return self.e._stopped(req, tok)

    def start_slot(self, req: Request, first: int) -> None:
        self.tokens[req.slot, 0] = first
        self.pos[req.slot] = req.prompt_len
        self.active[req.slot] = True

    def decode(self, active_map: Dict[int, Request]) -> Dict[int, int]:
        e = self.e
        dev = e.mesh.device
        step = e._stage_decodes[self.stage]
        e.steps_used.add(id(step))
        # the pool's own rows: every row on one device, this host's
        # across ranks (a killed host's rows decode inactive)
        rows = slice(e.first_slot, e.first_slot + e.local_slots)
        out = step(e.params, torch.from_numpy(self.tokens[rows]).to(dev),
                   self.caches, torch.from_numpy(self.pos[rows]).to(dev),
                   torch.from_numpy(self.active[rows]).to(dev))
        self.caches = out["caches"]
        ids = out["topk_ids"][:, 0]
        if e.host is not None:
            ids = torch.cat(collectives.all_gather(ids, e.dist, "batch"))
        ids = ids.cpu().numpy()
        e._check_storage(self.caches)
        return {gslot: int(ids[gslot]) for gslot in active_map}

    def set_stage(self, stage: int) -> None:
        if stage not in self.e._stage_decodes:
            raise RuntimeError(
                f"sharded pool: degrade stage {stage} was not pre-built "
                "— construct the ShardedEngine with the run's "
                "admission_policy")
        self.stage = stage

    def advance_slot(self, gslot: int, req: Request, tok: int) -> None:
        self.tokens[gslot, 0] = tok
        self.pos[gslot] += 1

    def stop_slot(self, gslot: int) -> None:
        self.active[gslot] = False

    def compact(self, perm: List[int]) -> None:
        p = np.asarray(perm, np.int64)
        self.caches = self.e._compact(self.caches, p)
        self.tokens = self.tokens[p]
        self.pos = self.pos[p]
        self.active = self.active[p]
        self.e._check_storage(self.caches)

    def host_killed(self, host: int) -> None:
        # the dead range stops decoding THIS step: clearing the active
        # mask is the data plane's whole epoch change (the row-skipping
        # grid skips it; row independence keeps the survivors' values)
        lo = host * self.e.slots_per_host
        self.active[lo:lo + self.e.slots_per_host] = False
        self.e._check_storage(self.caches)

    def host_down(self, host: int, reqs: List[Request]) -> None:
        # death is visible cluster-wide: scrub the dead range's host-side
        # state so the next occupant starts from the zeros a fresh pool
        # would (its cache rows are overwritten by insert at admission)
        lo = host * self.e.slots_per_host
        hi = lo + self.e.slots_per_host
        self.tokens[lo:hi] = 0
        self.pos[lo:hi] = 0
        self.active[lo:hi] = False
        self.e._check_storage(self.caches)


class _PoolPrefill(LMSlotProgram):
    """``LMSlotProgram``'s prefill half, the pool's prefill program: a
    B = 1 prefill at the exact prompt length and its first token.  It has
    no decode half: the pool decodes.  Across ranks ``dist`` is over
    ``mesh.model_mesh`` (this data shard's model group, ``data`` 1): the
    caches are this rank's ``model`` share and the first token comes from
    the logits gathered whole."""

    def __init__(self, cfg: ModelConfig, *, topk: int, device, dist):
        self.cfg = cfg
        self.topk = topk
        self.device = torch.device(device)
        self._prefill = steps_lib.make_prefill_step(cfg, dist)


class ShardedEngine:
    """Continuous batching over a data-axis-sharded slot pool.

    ``mesh`` (launch/mesh.make_serving_mesh) carries a ``data`` axis: one
    host per data shard, ``slots_per_host`` slots each.  On one device
    the pool holds all n_hosts * slots_per_host slots on ``mesh.device``;
    over a world of ranks (the module's docstring) every rank constructs
    the engine, its pool holds its host's rows and ``model`` share, and
    ``params`` are its shards (``train.parallel_state``).  ``run``
    consumes per-host workloads (``loadgen.sharded_workload``) through
    the transported admission protocol; across ranks every rank passes
    the whole workload and returns every request.  Eligibility is
    ``Engine.supports``; ``params`` must lie on the mesh's device.

    ``transport`` / ``compact_threshold`` / ``failpoints`` set the run
    defaults (each can be overridden per ``run`` call): ``"sim"`` and
    ``None`` serve without compaction over the in-process gossip;
    ``"collective"`` exchanges the same deltas through a gather on the
    device; a float threshold enables slot compaction; a ``FailPlan``
    replays a deterministic failure schedule (host kills, prefill
    faults, transport hangs, digest corruption) against the run, and
    recovery is part of the replicated schedule, so the engine's event
    log still equals the model-free sim's.  ``prefill_workers`` sizes the
    prefill pool over the mesh's device; the tokens are identical for
    any worker count.
    """

    def __init__(self, cfg: ModelConfig, params, *, mesh,
                 slots_per_host: int, max_len: int, topk: int = 8,
                 eos_id: Optional[int] = None, gossip_delay: int = 1,
                 prefill_workers: int = 1,
                 transport: Union[str, Transport] = "sim",
                 compact_threshold: Optional[float] = None,
                 failpoints=None,
                 admission_policy: Optional[AdmissionPolicy] = None):
        if not Engine.supports(cfg):
            raise NotImplementedError(
                f"{cfg.name}: sharded serving covers the same decoder-only "
                "token LMs as Engine (see Engine.supports)")
        assert slots_per_host >= 1 and max_len >= 2
        device = mesh.device
        if next(params.parameters()).device != device:
            raise ValueError(f"params on {next(params.parameters()).device},"
                             f" the mesh on {device}")
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.dist = sharding_lib.DistContext(mesh)
        self.n_hosts = int(self.dist.n_batch)
        self.slots_per_host = slots_per_host
        self.n_slots = self.n_hosts * slots_per_host
        # this rank's host across ranks (None on one device), and the
        # global slots of the pool's rows
        self.host = self.dist.batch_index if mesh.distributed else None
        self.first_slot, self.local_slots = steps_lib.local_rows(
            self.dist, slots_per_host)
        self.max_len = max_len
        self.topk = topk
        self.eos_id = eos_id
        self.gossip_delay = gossip_delay
        self.transport = transport
        self.compact_threshold = compact_threshold
        self.failpoints = failpoints if failpoints else None
        self.admission_policy = admission_policy
        steps_lib.warm_bloom_caches(cfg, params)

        # disaggregated prefill pool: B = 1 prefill at the exact prompt
        # length, FIFO over the workers; they share the params, which
        # already lie on the mesh's device (across ranks: this data
        # shard's model group prefills its own host's admissions)
        self._prefill_program = _PoolPrefill(
            cfg, topk=topk, device=device,
            dist=(None if self.host is None
                  else sharding_lib.DistContext(model_mesh(mesh))))
        self.prefill_pool = PrefillPool(
            params, program=self._prefill_program,
            n_workers=prefill_workers)

        # the sharded pool: allocated once, slot axis split over `data`
        # (and, across ranks, kv heads / Mamba heads over `model`)
        whole = tf.init_lm_cache(cfg, self.n_slots, max_len,
                                 dtype=getattr(torch, cfg.dtype),
                                 device="meta")
        self._pool_specs = sharding_lib.slot_pool_pspecs(
            whole, self.dist, self.n_slots, cfg)
        if self.host is not None:
            whole = [{k: sharding_lib.local_shard(v, specs[k], mesh)
                      for k, v in layer.items()}
                     for layer, specs in zip(whole, self._pool_specs)]
        self._pool = [{k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                       for k, v in layer.items()} for layer in whole]
        self.pool_storage_at_build = self.pool_storage()
        self.storage_checks = 0

        # the stage-0 decode step, built once and used by every run; the
        # degrade ladder's narrower-top-k steps are pre-built beside it,
        # so a DEGRADE/RESTORE is a dict lookup
        self.decode_steps_built = 0
        self._decode = self._build_decode(topk)
        self._stage_decodes = engine_lib.build_stage_decodes(
            self._decode, topk, admission_policy, self._build_decode)
        self.steps_used = set()
        self._insert = steps_lib.make_sharded_insert(
            self._pool_specs, self.dist, slots_per_host)
        self._compact = steps_lib.make_compact_pool(
            self._pool_specs, self.dist, slots_per_host)
        self._gather = None

    def _build_decode(self, k: int):
        self.decode_steps_built += 1
        return steps_lib.make_slot_decode_step(
            self.cfg, k, self.mesh.device,
            None if self.host is None else self.dist)

    def _owners_outcomes(self, reqs: List[Request], executor: Dict[int, int],
                         mine: Dict[int, Optional[int]]
                         ) -> Dict[int, Optional[int]]:
        """Every request's prefill outcome (its first token, or None for
        a reject), each from its owner: one all-gather over ``data`` of
        this rank's outcomes (-1 a reject, -2 not its host's)."""
        codes = torch.tensor(
            [(-1 if mine[r.rid] is None else mine[r.rid])
             if r.rid in mine else -2 for r in reqs],
            dtype=torch.int64, device=self.mesh.device)
        parts = torch.stack(collectives.all_gather(codes, self.dist,
                                                   "batch")).cpu().numpy()
        out = {}
        for i, r in enumerate(reqs):
            code = int(parts[executor[r.rid], i])
            assert code != -2, f"rid {r.rid}: its owner sent no outcome"
            out[r.rid] = None if code == -1 else code
        return out

    def pool_storage(self) -> Tuple[int, ...]:
        """The ``data_ptr()`` of every pool leaf, layer by layer."""
        return tuple(buf.data_ptr() for layer in self._pool
                     for buf in layer.values())

    def _check_storage(self, caches) -> None:
        if caches is not self._pool or \
                self.pool_storage() != self.pool_storage_at_build:
            raise RuntimeError("a pool leaf was reallocated: the sharded "
                               "pool must be updated in place")
        self.storage_checks += 1

    def _fresh_pool(self):
        # zero in place: the next run's pool is the same storage
        with torch.inference_mode():
            for layer in self._pool:
                for buf in layer.values():
                    buf.zero_()
        return self._pool

    def _stopped(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return len(req.tokens) >= req.max_gen

    def _make_transport(self,
                        transport: Union[str, Transport]) -> Transport:
        if isinstance(transport, Transport):
            return transport
        if transport == "sim":
            return SimTransport(self.gossip_delay)
        if transport == "collective":
            if self._gather is None:
                self._gather = make_device_gather(self.mesh)
            return CollectiveTransport(
                self.n_hosts, self.gossip_delay,
                capacity=COLLECTIVE_CAPACITY, gather=self._gather)
        raise ValueError(f"unknown transport {transport!r}")

    # ------------------------------------------------------------------
    def run(self, per_host_requests: List[List[Request]], *,
            transport: Union[str, Transport, None] = None,
            compact_threshold: Union[float, None, str] = "default",
            failpoints="default",
            admission_policy="default",
            ) -> Tuple[Dict[int, Request], ServeStats]:
        """Serve per-host arrival streams through the transported pool.

        The loop is literally ``scheduler.run_schedule``, the loop the
        model-free ``simulate_sharded_schedule`` runs, so with
        ``eos_id=None`` the engine's event log reproduces the
        simulation's integer for integer, COMPACT, RECLAIM, REJECT, SHED
        and DEGRADE events included: a ``FailPlan`` injects the same
        kills and prefill faults into both.
        """
        fp = self.failpoints if failpoints == "default" else (
            failpoints if failpoints else None)
        pol = (self.admission_policy if admission_policy == "default"
               else admission_policy)
        if pol is not None and pol.max_stage > 0 \
                and self.admission_policy is None:
            raise RuntimeError(
                "run() got an admission_policy with degrade stages but "
                "the engine was built without one — stage decode steps "
                "are PRE-BUILT at construction; pass admission_policy to "
                "ShardedEngine(...)")
        # the prefill pool consults the run's plan (it is engine-owned,
        # so re-point it per run; None restores fault-free behavior)
        self.prefill_pool.failpoints = fp
        sched = ShardedScheduler(
            self.n_hosts, self.slots_per_host, self.gossip_delay,
            transport=self._make_transport(
                self.transport if transport is None else transport),
            compact_threshold=(self.compact_threshold
                               if compact_threshold == "default"
                               else compact_threshold),
            failpoints=fp,
            admission_policy=pol)
        sched.push_workloads(per_host_requests)
        client = _PoolClient(self, sched)
        t0 = time.perf_counter()
        stats = run_schedule(sched, client)
        stats.wall_s = time.perf_counter() - t0
        self._sched = sched          # exposed for the simulation tests
        results = {r.rid: r for reqs in per_host_requests for r in reqs}
        return results, stats
