"""Data-axis-sharded serving: the port's ShardedEngine, its sharded insert
and compaction, the device gather of the collective transport, the serve
CLI's ``--sharded`` and the in-process multi-host drills, against the JAX
package on the same numpy inputs.

The reference's own ShardedEngine does not run under the installed JAX
(its pool decode raises ``ShardingTypeError`` at ``models/io.py:97``), so
the port is held to what does run there: its JAX-free
``simulate_sharded_schedule`` (the port's event logs equal it integer for
integer: plain, compact, host kill, overload) and its single-host Engine
(the port's tokens equal it exactly, on the reference's params carried
over by ``lm_params_from_jax``: qwen1.5-0.5b and mamba2-1.3b smoke, f32).
The reference's JAX-free multi-host tests run through both packages with
their results compared.  Everything runs on the CPU at smoke size."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serving as J
from repro.launch import steps as j_steps
from repro_torch import configs as tconfigs
from repro_torch import serving as T
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sharding
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf
from repro_torch.serving import sim_multihost as sim
from repro_torch.serving.collective import make_device_gather

from conftest import assert_slot_log_sound

PKGS = {"ref": J, "port": T}
QWEN, MAMBA = "qwen1.5-0.5b", "mamba2-1.3b"


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """(jcfg, tcfg, the reference's cast params, the port's model on
    them), made once per arch."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg))
    return jcfg, tcfg, jparams, t_steps.cast_params_for_compute(
        model, tcfg).eval().requires_grad_(False)


def _spec(S, vocab, n_requests=2):
    """The reference sim's LoadSpec in package ``S``."""
    return S.LoadSpec(n_requests=n_requests, vocab=vocab, rate=1.0,
                      prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=0)


def _overload_wl(S, vocab):
    return S.overload_workload(
        _spec(S, vocab, 3), sim.CHAOS_N_HOSTS,
        surge_start=sim.OVERLOAD_SURGE_START,
        surge_factor=sim.OVERLOAD_SURGE_FACTOR,
        deadline_slack=sim.OVERLOAD_DEADLINE_SLACK)


def _policy(S):
    p = sim.OVERLOAD_POLICY
    return S.AdmissionPolicy(max_queue_depth=p.max_queue_depth,
                             pressure_window=p.pressure_window,
                             degrade_lo=p.degrade_lo,
                             degrade_hi=p.degrade_hi,
                             restore_below=p.restore_below)


@pytest.fixture(scope="module")
def drills():
    """The port's in-process matrix, chaos and overload drills on the
    reference's qwen smoke params."""
    _, tcfg, _, model = _pair(QWEN)
    return {"run": sim.run(cfg=tcfg, model=model),
            "chaos": sim.run_chaos(cfg=tcfg, model=model),
            "overload": sim.run_overload(cfg=tcfg, model=model)}


def _reqs(wl):
    return [(r.rid, r.prompt.tolist(), r.max_gen, r.arrival_step, r.home,
             r.deadline_step) for reqs in wl for r in reqs]


@pytest.mark.parametrize("kind", ["sharded", "overload", "merged"])
def test_workloads_equal_the_reference(kind):
    vocab = tconfigs.get_smoke_config(QWEN).vocab

    def wl(S):
        if kind == "sharded":
            return S.sharded_workload(_spec(S, vocab), sim.N_HOSTS)
        if kind == "overload":
            return _overload_wl(S, vocab)
        return [S.merge_workloads(S.sharded_workload(_spec(S, vocab),
                                                     sim.N_HOSTS))]

    assert _reqs(wl(T)) == _reqs(wl(J)) and len(_reqs(wl(T))) >= 12


def _ref_log(*args, **kwargs):
    sched, stats = J.simulate_sharded_schedule(*args, **kwargs)
    return sim._log_of(sched), stats


@pytest.mark.parametrize("name", sim.RUNS)
def test_matrix_logs_equal_the_reference_sim(drills, name):
    """Each engine run's event log equals the reference's model-free
    replay for its compaction setting, integer for integer."""
    vocab = tconfigs.get_smoke_config(QWEN).vocab
    thresh = sim.COMPACT_THRESHOLD if name.endswith("compact") else None
    log, stats = _ref_log(J.sharded_workload(_spec(J, vocab), sim.N_HOSTS),
                          sim.SLOTS_PER_HOST, sim.GOSSIP_DELAY,
                          compact_threshold=thresh)
    got = drills["run"]["runs"][name]
    assert got["log"] == log and got["stats"] == stats.as_row()
    assert (got["stats"]["compactions"] > 0) == (thresh is not None)


def test_matrix_verifies_and_keeps_its_invariants(drills):
    """The reference's report checks (tokens equal across the four runs,
    the single-host Engine and solo static serving; logs equal to the
    model-free sim; compaction, both prefill workers, linearization) and
    the step and storage invariants over the whole matrix."""
    report = drills["run"]
    sim.verify_run(report)
    inv = report["invariants"]
    assert inv["decode_steps_built"] == 1 and inv["pool_storage_kept"]
    assert inv["storage_checks"] >= 4 * 14
    assert report["collective_rounds"] >= 2 * 14


def test_tokens_equal_the_reference_engine(drills):
    """The sharded runs' tokens equal the reference's single-host Engine
    on the merged workload (16 slots), bit for bit."""
    jcfg, _, jparams, _ = _pair(QWEN)
    jeng = J.Engine(jcfg, jparams, n_slots=sim.N_HOSTS * sim.SLOTS_PER_HOST,
                    max_len=sim.MAX_LEN, topk=sim.TOPK)
    res, _ = jeng.run(J.merge_workloads(
        J.sharded_workload(_spec(J, jcfg.vocab), sim.N_HOSTS)))
    want = {rid: r.tokens for rid, r in res.items()}
    for name in sim.RUNS:
        assert drills["run"]["runs"][name]["tokens"] == want, name
    assert drills["run"]["single"]["tokens"] == want


@pytest.mark.parametrize("drill", ["chaos", "overload"])
def test_drill_logs_equal_the_reference_sim(drills, drill):
    """The kill_host:1@3 and surge plans: both transports' logs equal the
    reference's replay of the same plan (RECLAIM, HOST_DOWN, SHED,
    DEGRADE included); the drills verified and kept the invariants."""
    vocab = tconfigs.get_smoke_config(QWEN).vocab
    d = drills[drill]
    assert d["verified"] is True
    if drill == "chaos":
        log, stats = _ref_log(
            J.sharded_workload(_spec(J, vocab), sim.CHAOS_N_HOSTS),
            sim.SLOTS_PER_HOST, sim.GOSSIP_DELAY,
            failpoints=J.FailPlan.parse(sim.CHAOS_FAILPOINTS))
        runs = d["kill_runs"]
        assert stats.requeued >= 1 and stats.host_downs == 1
        assert d["invariants"]["decode_steps_built"] == 1
    else:
        log, stats = _ref_log(
            _overload_wl(J, vocab), sim.SLOTS_PER_HOST, sim.GOSSIP_DELAY,
            failpoints=J.FailPlan.parse(sim.OVERLOAD_FAILPOINTS),
            admission_policy=_policy(J))
        runs = d["surge_runs"]
        assert stats.sheds > 0 and stats.degrades >= 2
        inv = d["invariants"]
        assert inv["decode_steps_built"] == inv["distinct_stage_steps"] >= 2
    for tname in ("sim", "collective"):
        assert runs[tname]["log"] == log, tname
    assert d["invariants"]["pool_storage_kept"]


def _filled_pool(cfg, n_slots, gen):
    pool = t_tf.init_lm_cache(cfg, n_slots, 12, dtype=torch.float32)
    for layer in pool:
        for buf in layer.values():
            buf.copy_(torch.randn(buf.shape, generator=gen))
    return pool


def _layout(cfg, n_hosts, sph):
    dist = t_sharding.DistContext(t_mesh.make_serving_mesh(n_hosts,
                                                           device="cpu"))
    pool = _filled_pool(cfg, n_hosts * sph, torch.Generator().manual_seed(0))
    return dist, pool, t_sharding.slot_pool_pspecs(pool, dist, n_hosts * sph)


def _snapshot(pool):
    return [{n: b.clone() for n, b in layer.items()} for layer in pool]


def _ptrs(pool):
    return [b.data_ptr() for layer in pool for b in layer.values()]


@pytest.mark.parametrize("arch", [QWEN, MAMBA])
def test_insert_touches_only_the_owning_rows(arch):
    cfg = tconfigs.get_smoke_config(arch)
    dist, pool, specs = _layout(cfg, 4, 2)
    insert = t_steps.make_sharded_insert(specs, dist, 2)
    before, ptrs = _snapshot(pool), _ptrs(pool)
    small = _filled_pool(cfg, 1, torch.Generator().manual_seed(1))
    for layer in small:
        for name in ("k", "v"):
            if name in layer:
                layer[name] = layer[name][:, :5].contiguous()
    insert(pool, small, 5, 2)
    assert _ptrs(pool) == ptrs
    for layer, old, sm in zip(pool, before, small):
        for name, buf in layer.items():
            keep = [r for r in range(8) if r != 5]
            assert torch.equal(buf[keep], old[name][keep]), name
            n = sm[name].shape[1]
            assert torch.equal(buf[5, :n], sm[name][0]), name
            if name in ("k", "v"):
                assert torch.equal(buf[5, n:], old[name][5, n:])
    with pytest.raises(AssertionError, match="one request"):
        insert(pool, _filled_pool(cfg, 2, torch.Generator()), 4, 2)
    moved = _snapshot(pool)
    for slot, host in ((8, 4), (5, 1), (5, 3), (1, 3)):
        with pytest.raises(AssertionError, match="outside"):
            insert(pool, small, slot, host)
    for layer, old in zip(pool, moved):
        for name, buf in layer.items():
            assert torch.equal(buf, old[name]), name


@pytest.mark.parametrize("arch", [QWEN, MAMBA])
def test_compaction_stays_within_hosts_and_refuses_crossing(arch):
    cfg = tconfigs.get_smoke_config(arch)
    dist, pool, specs = _layout(cfg, 3, 3)
    compact = t_steps.make_compact_pool(specs, dist, 3)
    before, ptrs = _snapshot(pool), _ptrs(pool)
    perm = [0, 1, 2, 5, 3, 4, 8, 7, 6]
    compact(pool, perm)
    assert _ptrs(pool) == ptrs
    for layer, old in zip(pool, before):
        assert {n for n in layer} >= ({"ssm", "conv_x"} if arch == MAMBA
                                      else {"k", "v"})
        for name, buf in layer.items():
            assert torch.equal(buf, old[name][perm]), name
    moved = _snapshot(pool)
    for bad in ([0, 1, 3, 2, 4, 5, 6, 7, 8], [0, 0, 2, 3, 4, 5, 6, 7, 8]):
        with pytest.raises(ValueError, match="across|permutation"):
            compact(pool, bad)
        for layer, old in zip(pool, moved):
            for name, buf in layer.items():
                assert torch.equal(buf, old[name])


def test_layout_and_mesh_refusals():
    cfg = tconfigs.get_smoke_config(QWEN)
    dist = t_sharding.DistContext(t_mesh.make_serving_mesh(4, device="cpu"))
    assert (dist.batch_axes, dist.n_batch, dist.n_model) == (("data",), 4, 1)
    pool = t_tf.init_lm_cache(cfg, 6, 8)
    with pytest.raises(ValueError, match="must divide the data axes"):
        t_sharding.slot_pool_pspecs(pool, dist, 6)
    specs = t_sharding.slot_pool_pspecs(t_tf.init_lm_cache(cfg, 8, 8), dist, 8)
    assert specs[0] == {"k": t_sharding.P(("data",), None, None, None),
                        "v": t_sharding.P(("data",), None, None, None)}
    mcfg = tconfigs.get_smoke_config(MAMBA)
    mspecs = t_sharding.slot_pool_pspecs(t_tf.init_lm_cache(mcfg, 8, 8),
                                         dist, 8)
    assert mspecs[0]["ssm"] == t_sharding.P(("data",), None, None, None)
    assert mspecs[0]["conv_c"] == t_sharding.P(("data",), None, None)
    one = t_sharding.DistContext(t_mesh.make_serving_mesh(device="cpu"))
    assert one.n_batch == 1 and t_sharding.slot_pool_pspecs(
        pool, one, 6)[0]["k"] == t_sharding.P(None, None, None, None)
    for make in (lambda: t_mesh.make_serving_mesh(4, model_parallel=2,
                                                  device="cpu"),
                 lambda: t_mesh.make_elastic_mesh(8, model_parallel=2,
                                                  device="cpu"),
                 t_mesh.make_production_mesh):
        with pytest.raises(NotImplementedError, match="A13b"):
            make()
    assert t_mesh.make_elastic_mesh(6, device="cpu").shape == {
        "data": 6, "model": 1}
    assert t_mesh.make_local_mesh(device="cpu").shape == {"data": 1,
                                                          "model": 1}
    with pytest.raises(ValueError, match="params on"):
        T.ShardedEngine(cfg, _pair(QWEN)[3], slots_per_host=1, max_len=8,
                        mesh=dataclasses.replace(
                            t_mesh.make_serving_mesh(2, device="cpu"),
                            device=torch.device("meta")))


def test_device_gather_equals_the_loopback():
    mesh = t_mesh.make_serving_mesh(4, device="cpu")
    g = make_device_gather(mesh)
    buf = np.random.default_rng(0).integers(
        -5, 50, size=(4, 5, 5)).astype(np.int32)
    got = g(buf)
    assert got.shape == (4, 4, 5, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, T.CollectiveTransport._loopback(buf))
    np.testing.assert_array_equal(
        got, J.CollectiveTransport._loopback(buf))
    vocab = 64
    logs = []
    for S, gather in ((T, g), (T, None), (J, None)):
        sched, stats = S.simulate_sharded_schedule(
            S.sharded_workload(S.LoadSpec(n_requests=4, vocab=vocab,
                                          rate=1.5, seed=3), 4), 2, 1,
            transport=S.CollectiveTransport(4, 1, capacity=2,
                                            gather=gather),
            compact_threshold=0.0)
        logs.append((sim._log_of(sched), dataclasses.asdict(stats)))
    assert logs[0] == logs[1] == logs[2] and g.rounds > 10


def test_corrupted_device_buffer_or_view_raises():
    """A host's digest row corrupted in its device buffer (after the
    commit, before the gather) raises ReplicaDivergence at that round;
    a view corrupted after the gather trips the replica-agreement assert;
    the corrupt_digest failpoint raises through the device gather too."""
    spec = T.LoadSpec(n_requests=3, vocab=64, rate=1.0, seed=2)
    mesh = t_mesh.make_serving_mesh(3, device="cpu")

    def corrupted(where):
        g = make_device_gather(mesh)
        commit, exchange = g.commit, g.exchange

        def bad_commit(buf):
            commit(buf)
            if where == "buffer" and g.rounds == 2:
                g.buffers[1][-1, 3] += 1

        def bad_exchange():
            if where == "view" and g.rounds == 2:
                out = exchange()
                out[2, 0, 0, 0] += 1
                return out
            return exchange()

        g.commit, g.exchange = bad_commit, bad_exchange
        return g

    with pytest.raises(T.ReplicaDivergence, match=r"step 2.*\[1\]"):
        T.simulate_sharded_schedule(
            T.sharded_workload(spec, 3), 2, 1,
            transport=T.CollectiveTransport(3, 1, capacity=4,
                                            gather=corrupted("buffer")))
    with pytest.raises(AssertionError, match="replicas diverged"):
        T.simulate_sharded_schedule(
            T.sharded_workload(spec, 3), 2, 1,
            transport=T.CollectiveTransport(3, 1, capacity=4,
                                            gather=corrupted("view")))
    with pytest.raises(T.ReplicaDivergence, match=r"step 2.*\[1\]"):
        T.simulate_sharded_schedule(
            T.sharded_workload(spec, 3), 2, 1,
            transport=T.CollectiveTransport(
                3, 1, capacity=4, gather=make_device_gather(mesh)),
            failpoints=T.FailPlan.parse("corrupt_digest:1@2"))


@pytest.mark.parametrize("arch", [QWEN, MAMBA])
def test_compact_run_equals_the_engines(arch):
    """One compacting collective run of the sim's workload: its log equals
    the reference's replay, its tokens the port's single-host Engine's
    and the reference's (mamba2: the ssm and conv leaves move with their
    slot)."""
    jcfg, tcfg, jparams, model = _pair(arch)
    eng = T.ShardedEngine(tcfg, model,
                          mesh=t_mesh.make_serving_mesh(sim.N_HOSTS,
                                                        device="cpu"),
                          slots_per_host=sim.SLOTS_PER_HOST,
                          max_len=sim.MAX_LEN, topk=sim.TOPK,
                          transport="collective",
                          compact_threshold=sim.COMPACT_THRESHOLD,
                          prefill_workers=2)
    res, stats = eng.run(T.sharded_workload(_spec(T, tcfg.vocab),
                                            sim.N_HOSTS))
    assert stats.compactions > 0 and all(r.done for r in res.values())
    assert_slot_log_sound(eng._sched, eng.n_slots)
    log, jstats = _ref_log(J.sharded_workload(_spec(J, jcfg.vocab),
                                              sim.N_HOSTS),
                           sim.SLOTS_PER_HOST, sim.GOSSIP_DELAY,
                           compact_threshold=sim.COMPACT_THRESHOLD)
    assert sim._log_of(eng._sched) == log
    assert stats.as_row() == jstats.as_row()
    got = {rid: r.tokens for rid, r in res.items()}
    single, _ = T.Engine(tcfg, model, n_slots=eng.n_slots,
                         max_len=sim.MAX_LEN, topk=sim.TOPK).run(
        T.merge_workloads(T.sharded_workload(_spec(T, tcfg.vocab),
                                             sim.N_HOSTS)))
    assert got == {rid: r.tokens for rid, r in single.items()}
    if arch == MAMBA:
        jres, _ = J.Engine(jcfg, jparams, n_slots=eng.n_slots,
                           max_len=sim.MAX_LEN, topk=sim.TOPK).run(
            J.merge_workloads(J.sharded_workload(_spec(J, jcfg.vocab),
                                                 sim.N_HOSTS)))
        assert got == {rid: r.tokens for rid, r in jres.items()}
        assert "ssm" in eng._pool[0]
    inv = sim.invariants(eng)
    assert inv["decode_steps_built"] == 1 and inv["pool_storage_kept"]


def test_serving_exports_match_the_reference():
    for name in ("Engine", "ShardedEngine", "CollectiveTransport",
                 "ReplicaDivergence", "TransportTimeout", "LoadSpec",
                 "host_stream", "sharded_workload", "merge_workloads",
                 "overload_workload", "replay_slot_log",
                 "simulate_sharded_schedule", "slo_attainment"):
        assert name in T.__all__ and name in J.__all__, name
        assert getattr(T, name).__name__ == getattr(J, name).__name__


def test_sim_multihost_cli_verifies_on_cpu(capsys, tmp_path):
    out = tmp_path / "r.json"
    sim.main(["--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    for line in ("sharded: verified", "chaos: verified",
                 "overload: verified"):
        assert line in text
    assert out.stat().st_size > 0


# ---------------------------------------------------------------------------
# The reference's JAX-free multi-host contracts, through both packages
# ---------------------------------------------------------------------------

def _host_stream_purity(S):
    spec = S.LoadSpec(n_requests=6, vocab=256, rate=0.8, seed=11)
    alone = S.host_stream(spec, host=3, n_hosts=8)
    full = S.sharded_workload(spec, 8)
    assert _reqs([alone]) == _reqs([full[3]])
    other = S.host_stream(spec, host=4, n_hosts=8)
    assert _reqs([other]) != _reqs([alone])
    rids = [r.rid for reqs in full for r in reqs]
    assert len(rids) == len(set(rids))
    assert all(r.home == h for h, reqs in enumerate(full) for r in reqs)
    return _reqs(full)


def _replay_identity(S):
    spec = S.LoadSpec(n_requests=5, vocab=128, rate=1.3, seed=7)
    logs = []
    for _ in range(2):
        sched, stats = S.simulate_sharded_schedule(
            S.sharded_workload(spec, 4), slots_per_host=2, gossip_delay=1)
        logs.append((sim._log_of(sched), dataclasses.asdict(stats)))
    assert logs[0] == logs[1]
    return logs[0]


def _gossip_delay(S):
    out = []
    for delay in (0, 1, 3):
        spec = S.LoadSpec(n_requests=4, vocab=64, rate=2.0, seed=5)
        wl = S.sharded_workload(spec, 2)
        arrival = {r.rid: r.arrival_step for reqs in wl for r in reqs}
        sched, _ = S.simulate_sharded_schedule(wl, slots_per_host=1,
                                               gossip_delay=delay)
        assert len(sched.admissions) == 8
        for step, gslot, rid, _ in sched.admissions:
            assert step >= arrival[rid] + delay
        last_release = {}
        for ev in sorted(sched.admissions + sched.releases,
                         key=lambda e: e[3]):
            step, gslot = ev[0], ev[1]
            if ev in sched.releases:
                last_release[gslot] = step
            elif gslot in last_release:
                assert step >= last_release[gslot] + delay
        out.append(sim._log_of(sched))
    return out


def _merged_order(S):
    spec = S.LoadSpec(n_requests=5, vocab=64, rate=1.0, seed=2)
    merged = S.merge_workloads(S.sharded_workload(spec, 3))
    keys = [(r.arrival_step, r.home, r.rid) for r in merged]
    assert keys == sorted(keys) and len(merged) == 15
    return keys


def _transport_equivalence(S):
    out = []
    for n_hosts, spp, delay, cap, thresh, seed in [
            (1, 1, 0, 1, None, 0), (2, 3, 1, 2, None, 1),
            (4, 2, 2, 8, None, 2), (3, 4, 1, 1, 0.0, 3),
            (2, 4, 0, 4, 0.25, 4), (8, 2, 3, 2, 0.0, 5)]:
        spec = S.LoadSpec(n_requests=4, vocab=64, rate=1.5, seed=seed)
        a, sa = S.simulate_sharded_schedule(
            S.sharded_workload(spec, n_hosts), spp, delay,
            compact_threshold=thresh)
        b, sb = S.simulate_sharded_schedule(
            S.sharded_workload(spec, n_hosts), spp, delay,
            transport=S.CollectiveTransport(n_hosts, delay, capacity=cap),
            compact_threshold=thresh)
        assert sim._log_of(a) == sim._log_of(b) and sa == sb
        out.append((sim._log_of(a), dataclasses.asdict(sa)))
    return out


def _compaction_soundness(S):
    spec = S.LoadSpec(n_requests=6, vocab=128, rate=2.0,
                      prompt_lens=(4, 8), gen_lens=(2, 5, 11), seed=3)
    out = []
    for n_hosts, spp in [(2, 4), (4, 2), (1, 6)]:
        s0, st0 = S.simulate_sharded_schedule(
            S.sharded_workload(spec, n_hosts), spp, 1)
        s1, st1 = S.simulate_sharded_schedule(
            S.sharded_workload(spec, n_hosts), spp, 1,
            compact_threshold=0.0)
        assert len(s1.compactions) > 0
        key = lambda evs: [(e[0], e[2]) for e in evs]   # noqa: E731
        assert key(s0.admissions) == key(s1.admissions)
        assert sorted(key(s0.releases)) == sorted(key(s1.releases))
        assert (st0.decode_steps, st0.idle_steps, st0.tokens_out) == \
            (st1.decode_steps, st1.idle_steps, st1.tokens_out)
        for _, perm, _ in s1.compactions:
            assert sorted(perm) == list(range(n_hosts * spp))
            assert all(new // spp == old // spp
                       for new, old in enumerate(perm))
        final = S.replay_slot_log(s1.admissions, s1.releases,
                                  s1.compactions, n_hosts * spp)
        assert all(o is None for o in final)
        out.append(sim._log_of(s1))
    return out


def _kill_twins(S):
    out = []
    for n_hosts, spp, gd, spec_str in [
            (2, 1, 0, "kill_host:0@2"), (4, 2, 1, "kill_host:1@3"),
            (3, 2, 2, "kill_host:2@4,kill_host:0@8"),
            (4, 1, 1, "kill_host:3@2,delay_arrivals:2@3")]:
        plan = S.FailPlan.parse(spec_str)
        spec = S.LoadSpec(n_requests=3, vocab=64, rate=1.5,
                          gen_lens=(2, 4, 7), seed=9)
        base_wl = S.sharded_workload(spec, n_hosts)
        S.simulate_sharded_schedule(base_wl, spp, gd)
        base = {r.rid: r.tokens for reqs in base_wl for r in reqs}
        kill_wl = S.sharded_workload(spec, n_hosts)
        sk, stk = S.simulate_sharded_schedule(kill_wl, spp, gd,
                                              failpoints=plan)
        reqs = [r for rs in kill_wl for r in rs]
        assert all(r.done and not r.rejected for r in reqs), spec_str
        assert {r.rid: r.tokens for r in reqs} == base, spec_str
        assert stk.host_downs == len(plan.kill_steps())
        assert stk.requeued == len(sk.reclaims) >= 1
        S.replay_slot_log(sk.admissions, sk.releases, sk.compactions,
                          sk.n_slots, rejects=sk.rejects,
                          reclaims=sk.reclaims)
        sc, stc = S.simulate_sharded_schedule(
            S.sharded_workload(spec, n_hosts), spp, gd,
            transport=S.CollectiveTransport(n_hosts, gd, capacity=4),
            failpoints=plan)
        assert sim._log_of(sk) == sim._log_of(sc) and stk == stc
        out.append((sim._log_of(sk), dataclasses.asdict(stk)))
    return out


def _overload_twins(S):
    policy_kw = dict(pressure_window=2, degrade_lo=0.25, degrade_hi=0.5,
                     restore_below=0.1)
    out, any_shed = [], False
    for n_hosts, spp, gd, spec_str, slack, depth in [
            (2, 1, 0, "surge:3@0", 2, None),
            (4, 2, 1, "surge:2@1,slow_decode:3@2", 4, 2),
            (3, 1, 1, "slow_decode:4@0", 3, 1),
            (2, 2, 0, "surge:4@2", 1, None)]:
        plan = S.FailPlan.parse(spec_str)
        policy = S.AdmissionPolicy(max_queue_depth=depth, **policy_kw)
        spec = S.LoadSpec(n_requests=4, vocab=64, rate=2.0,
                          gen_lens=(2, 4, 7), seed=13)

        def wl():
            return S.overload_workload(spec, n_hosts, surge_start=0,
                                       surge_factor=2, deadline_slack=slack)

        w = wl()
        sk, stk = S.simulate_sharded_schedule(w, spp, gd, failpoints=plan,
                                              admission_policy=policy)
        reqs = [r for rs in w for r in rs]
        assert all(r.done for r in reqs)
        shed = {r.rid for r in reqs if r.shed}
        any_shed |= bool(shed)
        assert stk.sheds == len(shed) == len(sk.sheds)
        for r in reqs:
            if r.shed:
                assert r.admitted_step < 0 and not r.tokens
            else:
                assert r.admitted_step >= 0 and len(r.tokens) == r.max_gen
        eff = {r.rid: (plan.effective_arrival(r.arrival_step), r.home,
                       r.rid) for r in reqs}
        order = [e[2] for e in sorted(sk.admissions, key=lambda e: e[3])]
        assert [eff[rid] for rid in order] == \
            sorted(eff[rid] for rid in order)
        S.replay_slot_log(sk.admissions, sk.releases, sk.compactions,
                          sk.n_slots, rejects=sk.rejects,
                          reclaims=sk.reclaims)
        sc, stc = S.simulate_sharded_schedule(
            wl(), spp, gd,
            transport=S.CollectiveTransport(n_hosts, gd, capacity=16),
            failpoints=plan, admission_policy=policy)
        assert sim._log_of(sk) == sim._log_of(sc) and stk == stc
        out.append((sim._log_of(sk), sorted(shed)))
    assert any_shed, "no case shed anything — the twins are vacuous"
    return out


def _prefill_reject(S):
    cap = S.PREFILL_MAX_ATTEMPTS
    spec = S.LoadSpec(n_requests=3, vocab=64, rate=1.0, gen_lens=(2, 4),
                      seed=4)
    base_wl = S.sharded_workload(spec, 2)
    S.simulate_sharded_schedule(base_wl, 2, 1)
    base = {r.rid: r.tokens for reqs in base_wl for r in reqs}
    victim = sorted(base)[1]
    wl = S.sharded_workload(spec, 2)
    s_ok, st_ok = S.simulate_sharded_schedule(
        wl, 2, 1, failpoints=S.FailPlan.parse(
            f"fail_prefill:{victim}:{cap - 1}"))
    assert st_ok.rejects == 0 and not s_ok.rejects
    assert {r.rid: r.tokens for rs in wl for r in rs} == base
    wl = S.sharded_workload(spec, 2)
    s_rj, st_rj = S.simulate_sharded_schedule(
        wl, 2, 1, failpoints=S.FailPlan.parse(
            f"fail_prefill:{victim}:{cap}"))
    assert st_rj.rejects == 1
    assert [e[2] for e in s_rj.rejects] == [victim]
    for r in (r for rs in wl for r in rs):
        if r.rid == victim:
            assert r.rejected and r.tokens == [] and r.done
        else:
            assert not r.rejected and r.tokens == base[r.rid]
    S.replay_slot_log(s_rj.admissions, s_rj.releases, s_rj.compactions,
                      s_rj.n_slots, rejects=s_rj.rejects,
                      reclaims=s_rj.reclaims)
    return sim._log_of(s_rj), cap


def _corrupted_replica(S):
    spec = S.LoadSpec(n_requests=3, vocab=64, rate=1.0, seed=2)
    plan = S.FailPlan.parse("corrupt_digest:1@2")
    msgs = []
    for transport in (None, S.CollectiveTransport(3, 1, capacity=4)):
        with pytest.raises(S.ReplicaDivergence,
                           match=r"step 2.*\[1\]") as e:
            S.simulate_sharded_schedule(S.sharded_workload(spec, 3), 2, 1,
                                        transport=transport,
                                        failpoints=plan)
        msgs.append(str(e.value))
    return msgs


def _hung_round(S):
    spec = S.LoadSpec(n_requests=3, vocab=64, rate=1.0, seed=2)
    msgs = []
    for transport in (None, S.CollectiveTransport(3, 1, capacity=4)):
        with pytest.raises(S.TransportTimeout, match="step 2") as e:
            S.simulate_sharded_schedule(
                S.sharded_workload(spec, 3), 2, 1, transport=transport,
                failpoints=S.FailPlan.parse("hang_round:99@2"))
        msgs.append(str(e.value))
    s0, _ = S.simulate_sharded_schedule(S.sharded_workload(spec, 3), 2, 1)
    s1, _ = S.simulate_sharded_schedule(
        S.sharded_workload(spec, 3), 2, 1,
        failpoints=S.FailPlan.parse("hang_round:4@2"))
    assert (s0.admissions, s0.releases) == (s1.admissions, s1.releases)
    return msgs, sim._log_of(s1)


def _delay0_readmission(S):
    reqs = [S.Request(rid=i, prompt=np.zeros(2, np.int32), max_gen=1,
                      arrival_step=0, home=0) for i in range(3)]
    sched, _ = S.simulate_sharded_schedule([reqs], slots_per_host=1,
                                           gossip_delay=0)
    assert all(r.done for r in reqs) and len(sched.admissions) == 3
    assert [e[0] for e in sched.admissions] == [0, 0, 0]
    return sim._log_of(sched)


CONTRACTS = {f.__name__[1:]: f for f in (
    _host_stream_purity, _replay_identity, _gossip_delay, _merged_order,
    _transport_equivalence, _compaction_soundness, _kill_twins,
    _overload_twins, _prefill_reject, _corrupted_replica, _hung_round,
    _delay0_readmission)}


@pytest.mark.parametrize("case", sorted(CONTRACTS))
def test_jax_free_contract_matches_the_reference(case):
    """The reference's JAX-free test (tests/test_serving_multihost.py)
    holds in each package, and the port's results equal the
    reference's."""
    results = {k: CONTRACTS[case](S) for k, S in PKGS.items()}
    assert results["port"] == results["ref"]
