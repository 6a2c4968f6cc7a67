"""Multi-host serving simulation, in-process.

The reference runs in a fresh process that forces an 8-device CPU
topology.  The port simulates its hosts as data shards of one device
(launch/mesh.py), so this runs in-process, with no subprocess and no
forced topology, on ``--device`` (``cuda`` by default; ``cpu`` at smoke
size).  It serves one seeded per-host workload through the whole
control/data-plane matrix and returns everything a verdict needs:

  * ``runs`` — ONE ShardedEngine (one decode step object, a prefill pool
    of 2 workers) driven through {sim, collective} transports x
    {no-compaction, compaction}: the collective runs gather the deltas on
    the device (serving/collective.py), the compaction runs remap the
    cache pool mid-flight;
  * ``single`` — the single-host Engine over the merged workload;
  * ``solo`` — each request alone through static serving;
  * ``sims`` — the model-free ``simulate_sharded_schedule`` replays (per
    compaction setting): the engine logs must equal them integer for
    integer, COMPACT events included.

Also recorded: per-host event logs (linearization), the two invariants
that stand for the reference's "decode compiled once" (the engine built
one decode step object and every run used it; every pool leaf kept its
storage), and the prefill pool's dispatch stats.  ``verify_run`` holds
the matrix to the reference's checks.

``run_chaos`` — the host-failure recovery drill: a 4-host mesh serves the
seeded workload while a committed ``FailPlan`` kills one host
mid-traffic, through both transports plus the model-free sim replay of
the same plan; ``_verify_chaos`` asserts that every request completes,
recovered tokens equal the fault-free twin's, re-admissions keep FIFO
order, the engine log equals the sim log (RECLAIM / HOST_DOWN included),
the slot log replays soundly, the drill requeued work, and the decode
step and pool storage survived the kill.

``run_overload`` — the overload drill: a surge plus a decode slowdown on
4 hosts under the committed AdmissionPolicy; ``_verify_overload`` asserts
sheds, the degrade ladder both ways, twin-equal served tokens, and log
equality with the model-free sim (SHED / DEGRADE included).

Over a world of ranks (``mesh``, a (data, model) mesh over
``torch.distributed``: ``train.spawn``'s, or ``make_serving_mesh`` given
the world's transport; ``rank_drills`` is one rank's entry) the
three drills serve the same workloads with each host's slot rows on its
own ranks (serving/sharded_pool.py): the matrix then takes the chaos
layout, ``mesh``'s data axis (4) hosts x 2 slots, so that one world
serves every drill.  Each rank returns its own logs, stats, tokens and
invariants, and the verifiers check each rank; a rank's matrix has no
single-host Engine or solo runs (its model is a shard), so its four
runs' tokens are held to each other, and the caller holds them to a
whole model's.

Usage:  python -m repro_torch.serving.sim_multihost --device cpu
        [--out report.json] [--full] [--arch ARCH]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import common as kernels_common
from repro_torch.launch import collectives, serve, sharding
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving.admission import AdmissionPolicy, slo_attainment
from repro_torch.serving.control import replay_slot_log
from repro_torch.serving.engine import Engine
from repro_torch.serving.failpoints import FailPlan
from repro_torch.serving.loadgen import (LoadSpec, arrival_span,
                                         merge_workloads, overload_workload,
                                         sharded_workload)
from repro_torch.serving.scheduler import simulate_sharded_schedule
from repro_torch.serving.sharded_pool import ShardedEngine

ARCH = "qwen1.5-0.5b"
N_HOSTS = 8
SLOTS_PER_HOST = 2        # >= 2 so per-host fragmentation can occur
MAX_LEN = 40
TOPK = 4
GOSSIP_DELAY = 1
PREFILL_WORKERS = 2
COMPACT_THRESHOLD = 0.25  # frag 0.5 (1 hole of 2 slots) crosses it
RUNS = ("sim_plain", "sim_compact", "collective_plain",
        "collective_compact")

# -- chaos drill (committed schedule; --failpoints overrides) -----------
CHAOS_N_HOSTS = 4         # kill 1 of 4 hosts
CHAOS_KILL_HOST = 1
CHAOS_KILL_STEP = 3       # inside arrival_span at seed 0: reclaims 2
CHAOS_FAILPOINTS = f"kill_host:{CHAOS_KILL_HOST}@{CHAOS_KILL_STEP}"

# -- overload drill (--overload-failpoints overrides) -------------------
# arrivals triple-compressed from step 1 on + every decode step costing
# 3 clock ticks from step 2 on: sustained arrival rate far above pool
# throughput, so the deadline/bounded-queue policy MUST shed and the
# pressure ladder MUST degrade and restore for the drill to pass
OVERLOAD_FAILPOINTS = "surge:3@1,slow_decode:3@2"
OVERLOAD_DEADLINE_SLACK = 8     # SLO: admitted within 8 clock ticks
OVERLOAD_SURGE_START = 1        # workload-level ramp (overload_workload)
OVERLOAD_SURGE_FACTOR = 2
# thresholds sized to the bounded queue: max_queue_depth=2 over 4 homes
# caps post-shed pending at 8 = the pool's 8 slots, so pressure tops out
# near 1.0 — the ladder trips at 2 queued (0.25) / 4 queued (0.5) and
# restores only once the queue is empty for a full window
OVERLOAD_POLICY = AdmissionPolicy(max_queue_depth=2, pressure_window=2,
                                  degrade_lo=0.25, degrade_hi=0.5,
                                  restore_below=0.1)


def build(arch: str = ARCH, full: bool = False, device=None, seed: int = 0):
    """(cfg, serving model) of ``arch``: smoke size unless ``full``,
    random weights from ``seed`` (``serve.build_model``)."""
    cfg = serve._config(arch, full)
    return cfg, serve.build_model(cfg, seed,
                                  kernels_common.resolve_device(device))


def _log_of(sched) -> dict:
    return {
        "admissions": sched.admissions,
        "releases": sched.releases,
        "compactions": [(step, list(perm), seq)
                        for step, perm, seq in sched.compactions],
        "rejects": sched.rejects,
        "reclaims": sched.reclaims,
        "host_downs": sched.host_downs,
        "sheds": sched.sheds,
        "degrades": sched.degrades,
        "per_host": [{"admissions": h.admissions,
                      "releases": h.releases,
                      "compactions": [(s, list(p), q)
                                      for s, p, q in h.compactions],
                      "rejects": h.rejects,
                      "reclaims": h.reclaims,
                      "sheds": h.sheds}
                     for h in sched.hosts],
    }


def invariants(engine: ShardedEngine) -> dict:
    """The counterpart of the reference's decode compile count: the
    engine built one decode step object per distinct top-k width, and
    every pool leaf kept its storage through every checked hook."""
    stage_ids = {st: id(fn) for st, fn in engine._stage_decodes.items()}
    return {
        "decode_steps_built": engine.decode_steps_built,
        "distinct_stage_steps": len(set(stage_ids.values())),
        "stage_steps_used": {st: i in engine.steps_used
                             for st, i in stage_ids.items()},
        "foreign_steps_used": len(engine.steps_used
                                  - set(stage_ids.values())),
        "storage_checks": engine.storage_checks,
        "pool_storage_kept": (engine.pool_storage()
                              == engine.pool_storage_at_build),
    }


def _check_invariants(inv: dict, what: str) -> None:
    assert inv["decode_steps_built"] == inv["distinct_stage_steps"], (
        f"{what}: {inv['decode_steps_built']} decode steps built for "
        f"{inv['distinct_stage_steps']} widths")
    assert inv["foreign_steps_used"] == 0, (
        f"{what}: a run decoded with a step the engine did not pre-build")
    assert inv["stage_steps_used"][0], f"{what}: stage 0 never decoded"
    assert inv["pool_storage_kept"] and inv["storage_checks"] > 0, (
        f"{what}: a pool leaf was reallocated")


def _steps(stats) -> int:
    """Prefills plus decode steps: each launches the embedding and the
    Eq. 3 top-k once."""
    return stats.prefills + stats.decode_steps


def _prefill_stats(engine: ShardedEngine) -> dict:
    """The prefill pool's dispatch counts (``jobs``, ``per_worker``):
    across ranks summed over ``data`` (each host's ranks prefill its own
    admissions), so that they count every host's."""
    st = dict(engine.prefill_pool.stats)
    if engine.host is None:
        return st
    mine = torch.tensor([st["jobs"], *st["per_worker"]], dtype=torch.int64,
                        device=engine.mesh.device)
    total = collectives.all_reduce_sum(mine, engine.dist, "batch").tolist()
    return {**st, "jobs": total[0], "per_worker": total[1:]}


def run(seed: int = 0, cfg=None, model=None, mesh=None, **build_kw) -> dict:
    """The matrix (the module's docstring) on ``N_HOSTS`` simulated hosts
    of one device, or over ``mesh``'s ranks with its data axis's hosts
    and no single-host or solo runs (``single`` and ``solo`` None)."""
    if model is None:
        cfg, model = build(**build_kw)
    # two requests per host per stream keeps the sim fast while still
    # exercising cross-host admission, mid-flight churn, and enough slot
    # fragmentation for the compaction runs to actually compact
    spec = LoadSpec(n_requests=2, vocab=cfg.vocab, rate=1.0,
                    prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=seed)
    mesh = _pool_mesh(mesh, model, N_HOSTS)
    n_hosts = mesh.shape["data"]
    engine = ShardedEngine(cfg, model, mesh=mesh,
                           slots_per_host=SLOTS_PER_HOST, max_len=MAX_LEN,
                           topk=TOPK, gossip_delay=GOSSIP_DELAY,
                           prefill_workers=PREFILL_WORKERS)
    model_steps = 0
    runs = {}
    for tname in ("sim", "collective"):
        for cname, thresh in (("plain", None),
                              ("compact", COMPACT_THRESHOLD)):
            res, stats = engine.run(sharded_workload(spec, n_hosts),
                                    transport=tname,
                                    compact_threshold=thresh)
            model_steps += _steps(stats)
            runs[f"{tname}_{cname}"] = {
                "tokens": {r.rid: r.tokens for r in res.values()},
                "done": {rid: r.done for rid, r in res.items()},
                "stats": stats.as_row(),
                "wall_s": stats.wall_s,
                "log": _log_of(engine._sched),
            }

    sims = {}
    for cname, thresh in (("plain", None), ("compact", COMPACT_THRESHOLD)):
        sim_sched, sim_stats = simulate_sharded_schedule(
            sharded_workload(spec, n_hosts), SLOTS_PER_HOST, GOSSIP_DELAY,
            compact_threshold=thresh)
        sims[cname] = {"stats": sim_stats.as_row(),
                       "log": _log_of(sim_sched)}

    single = solo_tokens = None
    if engine.host is None:
        one = Engine(cfg, model, n_slots=n_hosts * SLOTS_PER_HOST,
                     max_len=MAX_LEN, topk=TOPK)
        single_res, single_stats = one.run(
            merge_workloads(sharded_workload(spec, n_hosts)))
        model_steps += _steps(single_stats)
        single = {"tokens": {r.rid: r.tokens for r in single_res.values()},
                  "stats": single_stats.as_row(),
                  "wall_s": single_stats.wall_s}

        solo = Engine(cfg, model, n_slots=1, max_len=MAX_LEN, topk=TOPK)
        solo_tokens = {}
        for reqs in sharded_workload(spec, n_hosts):
            for req in reqs:
                req.arrival_step = 0
                r, st = solo.run_static([req])
                model_steps += _steps(st)
                solo_tokens[req.rid] = r[req.rid].tokens

    return {
        "device": str(mesh.device),
        "rank": mesh.rank,
        "mesh": list(mesh.sizes),
        "n_hosts": n_hosts,
        "slots_per_host": SLOTS_PER_HOST,
        "gossip_delay": GOSSIP_DELAY,
        "compact_threshold": COMPACT_THRESHOLD,
        "prefill_workers": PREFILL_WORKERS,
        # across the ENTIRE matrix: 4 engine runs through both transports,
        # with and without mid-flight cache remaps
        "invariants": invariants(engine),
        "pool_shapes": pool_shapes(engine),
        "prefill_stats": _prefill_stats(engine),
        "collective_rounds": engine._gather.rounds,
        "model_steps": model_steps,
        "runs": runs,
        "sims": sims,
        "single": single,
        "solo": solo_tokens,
    }


def _check_linearization(log: dict, n_hosts: int, sph: int,
                         name: str) -> None:
    """Merged-log soundness through COMPACT remaps, each request admitted
    exactly once, and the merged log restricted to each host's slot
    range reproduces that host's local log."""
    adm = [tuple(e) for e in log["admissions"]]
    rel = [tuple(e) for e in log["releases"]]
    comp = [(s, tuple(p), q) for s, p, q in log["compactions"]]
    final = replay_slot_log(adm, rel, comp, n_hosts * sph)
    assert all(o is None for o in final), f"{name}: slots left live"
    rids = [rid for _, _, rid, _ in adm]
    assert len(rids) == len(set(rids)), f"{name}: a request admitted twice"
    for h, hlog in enumerate(log["per_host"]):
        lo, hi = h * sph, (h + 1) * sph
        assert [tuple(e) for e in hlog["admissions"]] == \
            [e for e in adm if lo <= e[1] < hi], f"{name}: host {h} adm"
        assert [tuple(e) for e in hlog["releases"]] == \
            [e for e in rel if lo <= e[1] < hi], f"{name}: host {h} rel"
        assert [(s, tuple(p), q) for s, p, q in hlog["compactions"]] == \
            [(s, p[lo:hi], q) for s, p, q in comp
             if p[lo:hi] != tuple(range(lo, hi))], f"{name}: host {h} comp"
        for evs in (hlog["admissions"], hlog["releases"],
                    hlog["compactions"]):
            assert [e[-1] for e in evs] == sorted(e[-1] for e in evs), \
                f"{name}: host {h} seqs out of order"
        seqs = [e[-1] for e in hlog["admissions"] + hlog["releases"]
                + hlog["compactions"]]
        assert len(seqs) == len(set(seqs)), f"{name}: host {h} seq clash"


def verify_run(report: dict) -> None:
    """The reference's checks of the matrix (tests/test_serving_multihost
    on its report), held in this process: every request done; tokens
    equal across the four runs, the single-host Engine and solo static
    serving; each run's log equal to the model-free sim's, sim equal to
    collective; the compaction runs compacted and kept the schedule; both
    prefill workers used; sound, linearizable slot logs; the step and
    storage invariants."""
    solo = report["solo"]
    if solo is None:
        # a rank's matrix: its runs' tokens are held to each other here
        # and to a whole model's by the caller
        solo = report["runs"][RUNS[0]]["tokens"]
    else:
        single = report["single"]["tokens"]
        assert single == solo, "single-host Engine != solo static serving"
    assert solo, "solo run produced no results"
    for name in RUNS:
        r = report["runs"][name]
        assert r["done"] and all(r["done"].values()), f"{name}: not done"
        assert r["tokens"] == solo, f"{name}: tokens != solo"
        sim = report["sims"][name.split("_")[1]]
        assert r["log"] == sim["log"], f"{name}: log != model-free sim"
        assert r["stats"] == sim["stats"], f"{name}: stats != sim"
        _check_linearization(r["log"], report["n_hosts"],
                             report["slots_per_host"], name)
    for t in ("sim", "collective"):
        plain = report["runs"][f"{t}_plain"]
        comp = report["runs"][f"{t}_compact"]
        assert comp["stats"]["compactions"] > 0, f"{t}: never compacted"
        assert len(comp["log"]["compactions"]) == \
            comp["stats"]["compactions"]
        assert plain["stats"]["compactions"] == 0
        key = lambda evs: [(e[0], e[2]) for e in evs]   # noqa: E731
        assert key(plain["log"]["admissions"]) == \
            key(comp["log"]["admissions"]), f"{t}: compaction moved adm"
        assert sorted(key(plain["log"]["releases"])) == \
            sorted(key(comp["log"]["releases"])), f"{t}: compaction rel"
        assert plain["stats"]["decode_steps"] == \
            comp["stats"]["decode_steps"]
    for c in ("plain", "compact"):
        assert report["runs"][f"sim_{c}"]["log"] == \
            report["runs"][f"collective_{c}"]["log"], f"sim != coll ({c})"
    st = report["prefill_stats"]
    total = sum(r["stats"]["prefills"] for r in report["runs"].values())
    assert st["jobs"] == total and sum(st["per_worker"]) == st["jobs"]
    assert len(st["per_worker"]) == report["prefill_workers"] == 2
    assert all(c > 0 for c in st["per_worker"]), "a prefill worker idled"
    assert report["collective_rounds"] > 0
    _check_invariants(report["invariants"], "matrix")


def _pool_mesh(mesh, model, n_hosts: int):
    """A drill's mesh: ``mesh`` (over ranks, its data axis the hosts) or
    ``n_hosts`` simulated hosts on the model's device."""
    if mesh is not None:
        return mesh
    return make_serving_mesh(n_hosts=n_hosts, device=model.embed.device)


def _drill_mesh(mesh, model):
    """The chaos and overload drills' mesh (``_pool_mesh``), of
    ``CHAOS_N_HOSTS`` hosts."""
    mesh = _pool_mesh(mesh, model, CHAOS_N_HOSTS)
    if mesh.shape["data"] != CHAOS_N_HOSTS:
        raise ValueError(f"the drills kill 1 of {CHAOS_N_HOSTS} hosts: "
                         f"mesh {mesh.sizes} has {mesh.shape['data']}")
    return mesh


def _verify_chaos(chaos: dict, arrival_key: dict) -> None:
    """Hard asserts on the recovery drill.  `arrival_key[rid]` is the
    original (arrival_step, home, rid) FIFO key of each request."""
    base = chaos["base"]
    assert all(base["done"].values()), "fault-free twin did not finish"
    for tname in ("sim", "collective"):
        kr = chaos["kill_runs"][tname]
        # 1. no request lost or rejected under a pure kill plan
        assert all(kr["done"].values()), f"{tname}: lost requests"
        assert kr["stats"]["rejects"] == 0, f"{tname}: spurious rejects"
        # 2. the drill is non-vacuous: the kill reclaimed live work
        assert kr["stats"]["host_downs"] == 1, f"{tname}: no HOST_DOWN"
        assert kr["stats"]["requeued"] >= 1, (
            f"{tname}: kill at step {chaos['kill_step']} reclaimed "
            "nothing — move it inside the arrival span")
        # 3. recovered tokens equal the fault-free twin's (greedy decode
        #    is pure in the prompt, so a re-prefilled request regenerates
        #    its exact stream)
        assert kr["tokens"] == base["tokens"], f"{tname}: token drift"
        # 4. re-admissions preserve FIFO order among requeued requests:
        #    each reclaimed rid's LAST admission is its re-admission;
        #    within one HOST_DOWN wave the re-admissions must follow the
        #    original (arrival_step, home, rid) keys
        last_adm = {}
        wave = {}                      # rid -> its LAST reclaim step
        for step, _, rid, _ in kr["log"]["reclaims"]:
            wave[rid] = step
        for _, _, rid, seq in kr["log"]["admissions"]:
            if rid in wave:
                last_adm[rid] = seq
        assert set(last_adm) == set(wave), (
            f"{tname}: reclaimed request never re-admitted")
        for w in set(wave.values()):
            order = sorted((rid for rid, s in wave.items() if s == w),
                           key=last_adm.get)
            keys = [arrival_key[rid] for rid in order]
            assert keys == sorted(keys), (
                f"{tname}: re-admissions out of FIFO order: {order}")
        # 5. slot log replays soundly with RECLAIM events
        replay_slot_log(kr["log"]["admissions"], kr["log"]["releases"],
                        [(s, list(p), q) for s, p, q
                         in kr["log"]["compactions"]],
                        chaos["n_hosts"] * chaos["slots_per_host"],
                        rejects=kr["log"]["rejects"],
                        reclaims=kr["log"]["reclaims"])
    # 6. engine log == model-free sim log, integer for integer
    assert chaos["kill_runs"]["sim"]["log"] == chaos["kill_sim"]["log"], \
        "engine/sim log divergence under kill"
    assert (chaos["kill_runs"]["collective"]["log"]
            == chaos["kill_sim"]["log"]), \
        "collective transport log divergence under kill"
    # 7. one decode step object and one pool storage across the fault-free
    #    and both kill runs: host death is an active-mask change
    _check_invariants(chaos["invariants"], "chaos")
    assert chaos["invariants"]["decode_steps_built"] == 1


def run_chaos(seed: int = 0, failpoints: str | None = None, cfg=None,
              model=None, mesh=None, **build_kw) -> dict:
    spec_str = CHAOS_FAILPOINTS if failpoints is None else failpoints
    plan = FailPlan.parse(spec_str)
    if model is None:
        cfg, model = build(**build_kw)
    spec = LoadSpec(n_requests=2, vocab=cfg.vocab, rate=1.0,
                    prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=seed)

    def wl():
        return sharded_workload(spec, CHAOS_N_HOSTS)

    first, last = arrival_span(wl())
    arrival_key = {r.rid: (r.arrival_step, r.home, r.rid)
                   for reqs in wl() for r in reqs}

    mesh = _drill_mesh(mesh, model)
    engine = ShardedEngine(cfg, model, mesh=mesh,
                           slots_per_host=SLOTS_PER_HOST, max_len=MAX_LEN,
                           topk=TOPK, gossip_delay=GOSSIP_DELAY,
                           prefill_workers=PREFILL_WORKERS)
    model_steps = 0

    def pack(res, stats, sched) -> dict:
        nonlocal model_steps
        model_steps += _steps(stats)
        return {
            "tokens": {r.rid: r.tokens for r in res.values()},
            "done": {rid: r.done for rid, r in res.items()},
            "stats": {**stats.as_row(), "host_downs": stats.host_downs,
                      "requeued": stats.requeued,
                      "rejects": stats.rejects},
            "log": _log_of(sched),
        }

    base_res, base_stats = engine.run(wl(), transport="sim",
                                      failpoints=None)
    base = pack(base_res, base_stats, engine._sched)

    kill_runs = {}
    for tname in ("sim", "collective"):
        res, stats = engine.run(wl(), transport=tname, failpoints=plan)
        kill_runs[tname] = pack(res, stats, engine._sched)

    kill_sim_sched, kill_sim_stats = simulate_sharded_schedule(
        wl(), SLOTS_PER_HOST, GOSSIP_DELAY, failpoints=plan)
    kill_sim = {"stats": {**kill_sim_stats.as_row(),
                          "host_downs": kill_sim_stats.host_downs,
                          "requeued": kill_sim_stats.requeued,
                          "rejects": kill_sim_stats.rejects},
                "log": _log_of(kill_sim_sched)}

    chaos = {
        "failpoints": spec_str,
        "kill_step": plan.kill_steps()[0] if plan.kill_steps() else None,
        "arrival_span": [first, last],
        "n_hosts": CHAOS_N_HOSTS,
        "slots_per_host": SLOTS_PER_HOST,
        "gossip_delay": GOSSIP_DELAY,
        "invariants": invariants(engine),
        "model_steps": model_steps,
        "base": base,
        "kill_runs": kill_runs,
        "kill_sim": kill_sim,
    }
    if plan.kill_steps():          # custom plans may inject other faults
        _verify_chaos(chaos, arrival_key)
        chaos["verified"] = True
    return chaos


def _verify_overload(ov: dict) -> None:
    """Hard asserts on the overload drill: under the injected surge every
    request either completes with the unloaded twin's tokens or is shed
    deterministically — never both — the shed set is identical across
    SimTransport / CollectiveTransport / the model-free sim, the degrade
    ladder escalated AND restored with pre-built steps only, and SLO
    attainment is the arithmetic of the shed count."""
    base = ov["base"]
    assert all(base["done"].values()), "unloaded twin did not finish"
    assert base["stats"]["sheds"] == 0, "unloaded twin shed requests"
    n_total = len(base["done"])
    shed_sets = {}
    for tname in ("sim", "collective"):
        sr = ov["surge_runs"][tname]
        shed = set(sr["shed_rids"])
        served = {rid for rid, d in sr["done"].items() if d} - shed
        shed_sets[tname] = shed
        # 1. the drill is non-vacuous and clean
        assert sr["stats"]["sheds"] > 0, f"{tname}: surge shed nothing"
        assert sr["stats"]["rejects"] == 0, f"{tname}: spurious rejects"
        assert served | shed == set(sr["done"]), (
            f"{tname}: request neither served nor shed")
        # 2. no request is both served and shed
        assert not (served & shed), (
            f"{tname}: shed AND completed: {sorted(served & shed)}")
        # 3. every served request's tokens equal the unloaded twin's
        #    (degradation narrows the served top-k; the next token is the
        #    top-1 id, invariant under the width)
        for rid in served:
            assert sr["tokens"][rid] == base["tokens"][rid], (
                f"{tname}: rid {rid} token drift under overload")
        # 4. the ladder moved both ways
        degr = sr["log"]["degrades"]
        assert any(new > old for _, old, new, _ in degr), (
            f"{tname}: pressure never degraded the pool")
        assert any(new < old for _, old, new, _ in degr), (
            f"{tname}: pool never restored after the surge drained")
        # 5. SLO attainment is the arithmetic of the shed count
        assert sr["stats"]["sheds"] == len(shed), (
            f"{tname}: stats.sheds != marked shed requests")
        assert sr["slo_attainment"] == slo_attainment(
            n_total - sr["stats"]["sheds"], n_total)
        # 6. the slot log replays soundly
        replay_slot_log(sr["log"]["admissions"], sr["log"]["releases"],
                        [(s, list(p), q) for s, p, q
                         in sr["log"]["compactions"]],
                        ov["n_hosts"] * ov["slots_per_host"],
                        rejects=sr["log"]["rejects"],
                        reclaims=sr["log"]["reclaims"])
    # 7. shed decisions are deterministic and transport-invariant
    assert shed_sets["sim"] == shed_sets["collective"], (
        "shed set differs between transports")
    assert shed_sets["sim"] == set(ov["surge_sim"]["shed_rids"]), (
        "engine shed set differs from the model-free sim")
    # 8. engine log == model-free sim log, SHED / DEGRADE included
    assert ov["surge_runs"]["sim"]["log"] == ov["surge_sim"]["log"], \
        "engine/sim log divergence under overload"
    assert (ov["surge_runs"]["collective"]["log"]
            == ov["surge_sim"]["log"]), \
        "collective transport log divergence under overload"
    # 9. every DEGRADE/RESTORE was a lookup of a pre-built step: one step
    #    object per width, every stage the ladder entered decoded with
    #    its own, and the pool kept its storage
    inv = ov["invariants"]
    _check_invariants(inv, "overload")
    entered = {0} | {new for _, _, new, _
                     in ov["surge_runs"]["sim"]["log"]["degrades"]}
    for st in entered:
        assert inv["stage_steps_used"][st], f"stage {st} never decoded"


def run_overload(seed: int = 0, failpoints: str | None = None, cfg=None,
                 model=None, mesh=None, **build_kw) -> dict:
    """The overload chaos drill: the seeded per-host workload (ramped,
    deadline-tagged — loadgen.overload_workload) served on a 4-host mesh
    under an injected arrival surge + decode slowdown, with the
    committed AdmissionPolicy shedding and degrading; the unloaded twin
    serves the identical workload with no injection and no policy."""
    spec_str = OVERLOAD_FAILPOINTS if failpoints is None else failpoints
    plan = FailPlan.parse(spec_str)
    if model is None:
        cfg, model = build(**build_kw)
    spec = LoadSpec(n_requests=3, vocab=cfg.vocab, rate=1.0,
                    prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=seed)

    def wl():
        return overload_workload(
            spec, CHAOS_N_HOSTS, surge_start=OVERLOAD_SURGE_START,
            surge_factor=OVERLOAD_SURGE_FACTOR,
            deadline_slack=OVERLOAD_DEADLINE_SLACK)

    mesh = _drill_mesh(mesh, model)
    engine = ShardedEngine(cfg, model, mesh=mesh,
                           slots_per_host=SLOTS_PER_HOST, max_len=MAX_LEN,
                           topk=TOPK, gossip_delay=GOSSIP_DELAY,
                           prefill_workers=PREFILL_WORKERS,
                           admission_policy=OVERLOAD_POLICY)
    n_total = CHAOS_N_HOSTS * spec.n_requests
    model_steps = 0

    def pack(res, stats, sched) -> dict:
        nonlocal model_steps
        model_steps += _steps(stats)
        shed = sorted(r.rid for r in res.values() if r.shed)
        return {
            "tokens": {r.rid: r.tokens for r in res.values()},
            "done": {rid: r.done for rid, r in res.items()},
            "shed_rids": shed,
            "slo_attainment": slo_attainment(n_total - len(shed),
                                             n_total),
            "stats": {**stats.as_row(), "sheds": stats.sheds,
                      "degrades": stats.degrades,
                      "rejects": stats.rejects},
            "log": _log_of(sched),
        }

    # the unloaded twin: same workload, no injection, no policy — every
    # request serves to completion at full width
    base_res, base_stats = engine.run(wl(), transport="sim",
                                      failpoints=None,
                                      admission_policy=None)
    base = pack(base_res, base_stats, engine._sched)

    surge_runs = {}
    for tname in ("sim", "collective"):
        res, stats = engine.run(wl(), transport=tname, failpoints=plan)
        surge_runs[tname] = pack(res, stats, engine._sched)

    sim_sched, sim_stats = simulate_sharded_schedule(
        wl(), SLOTS_PER_HOST, GOSSIP_DELAY, failpoints=plan,
        admission_policy=OVERLOAD_POLICY)
    shed_sim = sorted(rid for _, rid, _, _ in sim_sched.log.sheds)
    surge_sim = {"shed_rids": shed_sim,
                 "stats": {**sim_stats.as_row(),
                           "sheds": sim_stats.sheds,
                           "degrades": sim_stats.degrades,
                           "rejects": sim_stats.rejects},
                 "log": _log_of(sim_sched)}

    overload = {
        "failpoints": spec_str,
        "overload_steps": plan.overload_steps(),
        "policy": {"max_queue_depth": OVERLOAD_POLICY.max_queue_depth,
                   "pressure_window": OVERLOAD_POLICY.pressure_window,
                   "degrade_lo": OVERLOAD_POLICY.degrade_lo,
                   "degrade_hi": OVERLOAD_POLICY.degrade_hi,
                   "restore_below": OVERLOAD_POLICY.restore_below,
                   "degraded_topk": OVERLOAD_POLICY.degraded_topk},
        "deadline_slack": OVERLOAD_DEADLINE_SLACK,
        "n_hosts": CHAOS_N_HOSTS,
        "slots_per_host": SLOTS_PER_HOST,
        "gossip_delay": GOSSIP_DELAY,
        "n_requests": n_total,
        "invariants": invariants(engine),
        "model_steps": model_steps,
        "base": base,
        "surge_runs": surge_runs,
        "surge_sim": surge_sim,
    }
    if plan.overload_steps():      # custom plans may not inject overload
        _verify_overload(overload)
        overload["verified"] = True
    return overload


def pool_shapes(engine: ShardedEngine) -> list:
    """Every pool leaf's shape, layer by layer (a rank's: its rows and
    its ``model`` share)."""
    return [{k: list(v.shape) for k, v in layer.items()}
            for layer in engine._pool]


def run_compact(seed: int = 0, cfg=None, model=None, mesh=None,
                n_hosts: int | None = None, **build_kw) -> dict:
    """One compacting collective run of the matrix's workload (on
    ``mesh``'s data-axis hosts, or ``n_hosts`` simulated ones, default
    ``N_HOSTS``), held to the model-free sim's replay (log and stats
    equal) and to the step and storage invariants.  Returns its tokens,
    stats, log, invariants and the pool's leaf shapes."""
    if model is None:
        cfg, model = build(**build_kw)
    mesh = _pool_mesh(mesh, model, n_hosts or N_HOSTS)
    n_hosts = mesh.shape["data"]
    spec = LoadSpec(n_requests=2, vocab=cfg.vocab, rate=1.0,
                    prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=seed)
    engine = ShardedEngine(cfg, model, mesh=mesh,
                           slots_per_host=SLOTS_PER_HOST, max_len=MAX_LEN,
                           topk=TOPK, gossip_delay=GOSSIP_DELAY,
                           transport="collective",
                           compact_threshold=COMPACT_THRESHOLD,
                           prefill_workers=PREFILL_WORKERS)
    res, stats = engine.run(sharded_workload(spec, n_hosts))
    sim_sched, sim_stats = simulate_sharded_schedule(
        sharded_workload(spec, n_hosts), SLOTS_PER_HOST, GOSSIP_DELAY,
        compact_threshold=COMPACT_THRESHOLD)
    out = {"tokens": {r.rid: r.tokens for r in res.values()},
           "done": {rid: r.done for rid, r in res.items()},
           "stats": stats.as_row(), "wall_s": stats.wall_s,
           "log": _log_of(engine._sched), "invariants": invariants(engine),
           "pool_shapes": pool_shapes(engine),
           "model_steps": _steps(stats)}
    assert all(out["done"].values()), "compact run: a request not done"
    assert stats.compactions > 0, "compact run: never compacted"
    assert out["log"] == _log_of(sim_sched), "compact run: log != sim"
    assert out["stats"] == sim_stats.as_row(), "compact run: stats != sim"
    _check_invariants(out["invariants"], "compact run")
    return out


DRILLS = {"run": run, "chaos": run_chaos, "overload": run_overload,
          "compact": run_compact}


def rank_drills(mesh, cfg, params, drills=("run", "chaos", "overload"),
                seed: int = 0) -> dict:
    """One rank's drills over ``mesh`` (a world mesh whose data axis is
    the hosts): rank 0's full ``params`` (name -> tensor or array, read
    on rank 0 only) broadcast and sharded (``serve.rank_model``), then
    each of ``drills`` (``DRILLS``' names) run and verified on this rank
    (``verify_run`` for "run"; the others verify themselves).  Returns
    {drill: its report}."""
    model = serve.rank_model(cfg, sharding.DistContext(mesh), params, seed)
    out = {}
    for name in drills:
        out[name] = DRILLS[name](seed, cfg=cfg, model=model, mesh=mesh)
        if name == "run":
            verify_run(out[name])
        elif name != "compact":
            assert out[name].get("verified") is True, name
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: its smoke size)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--failpoints", default=None,
                    help="chaos failpoint spec (default: "
                         f"{CHAOS_FAILPOINTS!r})")
    ap.add_argument("--overload-failpoints", default=None,
                    help="overload drill spec (default: "
                         f"{OVERLOAD_FAILPOINTS!r})")
    args = ap.parse_args(argv)
    device = kernels_common.resolve_device(args.device)
    if device.type == "cuda":
        kernels_common.build()
    cfg, model = build(args.arch, args.full, device)
    report = run(seed=args.seed, cfg=cfg, model=model)
    verify_run(report)
    print(f"sharded: verified ({cfg.name} {cfg.num_layers}L, {N_HOSTS} "
          f"hosts x {SLOTS_PER_HOST} slots, {device})")
    report["chaos"] = run_chaos(seed=args.seed, failpoints=args.failpoints,
                                cfg=cfg, model=model)
    report["overload"] = run_overload(
        seed=args.seed, failpoints=args.overload_failpoints, cfg=cfg,
        model=model)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
        print("wrote", args.out)
    print("chaos: verified" if report["chaos"].get("verified")
          else "chaos: ran (no kill in plan — checks skipped)")
    print("overload: verified" if report["overload"].get("verified")
          else "overload: ran (no surge in plan — checks skipped)")
    return report


if __name__ == "__main__":
    main()
