"""The sharded slot pool with each host's rows on its own ranks: four CPU
processes over gloo, started by ``launch/train.spawn``, against the JAX
package's model-free ``simulate_sharded_schedule`` (event logs equal,
integer for integer) and its single-host ``Engine`` (tokens equal, on
the reference's params carried over by ``lm_params_from_jax``).

One world of four ranks runs every job (``train.run_jobs``): on mesh
4x1 the qwen1.5-0.5b smoke matrix (four runs), chaos and overload drills
(``sim_multihost.rank_drills``, 4 hosts x 2 slots) and an olmoe-1b-7b
compacting run, whose owner-only prefill must not enter the MoE router's
collectives over ``data``; on mesh 2x2 one compacting run each of qwen
(4 kv heads, 2 a rank) and mamba2-1.3b (8 SSD heads, 4 a rank).  Every
run's tokens equal the reference's Engine's exactly.  The same world
also serves ``serve --sharded --mesh 2x2``'s rank path
(``serve._sharded_rank``), held to the entry point's one-device run.
The spawn
is bounded by the time left of 85 s from the fixture's start
(``spawn``'s ``timeout``).  Outside the spawn: the pool's specs at
(2, 2) against the reference's rule, the serving mesh's refusal without
a world, and a rank that received a corrupted row."""
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serving as J
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch import serving as T
from repro_torch.launch import collectives
from repro_torch.launch import serve
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sharding
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf
from repro_torch.serving import collective as t_collective
from repro_torch.serving import sim_multihost as sim

QWEN, OLMOE, MAMBA = "qwen1.5-0.5b", "olmoe-1b-7b", "mamba2-1.3b"
HOSTS = sim.CHAOS_N_HOSTS
JOBS = (((4, 1), QWEN, ("run", "chaos", "overload")),
        ((4, 1), OLMOE, ("compact",)),
        ((2, 2), QWEN, ("compact",)),
        ((2, 2), MAMBA, ("compact",)))
# ``serve --sharded`` at smoke size with a compacting collective transport
SERVE_KW = dict(arch=QWEN, slots_per_host=2, requests=3, rate=1.0,
                prompt_len=8, gen=6, topk=4, seed=0, full=False, eos_id=None,
                gossip_delay=1, transport="collective", prefill_workers=1,
                compact_threshold=sim.COMPACT_THRESHOLD, table_dtype=None,
                failpoints=None, deadline_slack=None, max_queue_depth=None)


def _params(arch):
    """(jcfg, tcfg, the reference's cast params, the port's params on
    them as numpy)."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    sd = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, {n: t.numpy() for n, t in sd.items()}


def _spec(S, vocab):
    return S.LoadSpec(n_requests=2, vocab=vocab, rate=1.0,
                      prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=0)


@pytest.fixture(scope="module")
def ranks():
    """{job index: [each rank's reports]} of the one spawn, and the
    params by arch."""
    end = time.monotonic() + 85.0
    params = {a: _params(a) for a in (QWEN, OLMOE, MAMBA)}
    cases = [(shape, sim.rank_drills, (params[a][1], params[a][3], drills))
             for shape, a, drills in JOBS]
    cases.append(((2, 2), serve._sharded_rank, (SERVE_KW,)))
    out = t_train.spawn(t_train.run_jobs, (4, 1), "gloo", "cpu", (cases,),
                        timeout=max(end - time.monotonic(), 1.0))
    return {i: [r[i] for r in out] for i in range(len(cases))}, params


def _ref_log(wl, **kw):
    sched, stats = J.simulate_sharded_schedule(wl, sim.SLOTS_PER_HOST,
                                               sim.GOSSIP_DELAY, **kw)
    return sim._log_of(sched), stats


def _ref_tokens(arch, params, hosts=HOSTS):
    """The reference's single-host Engine's tokens on the merged workload
    of ``hosts`` hosts (``hosts * SLOTS_PER_HOST`` slots)."""
    jcfg, _, jparams, _ = params[arch]
    res, _ = J.Engine(jcfg, jparams, n_slots=hosts * sim.SLOTS_PER_HOST,
                      max_len=sim.MAX_LEN, topk=sim.TOPK).run(
        J.merge_workloads(J.sharded_workload(_spec(J, jcfg.vocab), hosts)))
    return {rid: r.tokens for rid, r in res.items()}


@pytest.mark.parametrize("name", sim.RUNS)
def test_rank_matrix_logs_equal_the_reference_sim(ranks, name):
    """Mesh 4x1: each rank's run of the matrix logs what the reference's
    model-free replay logs for its compaction setting (COMPACT
    included), and the runs verified on every rank."""
    out, params = ranks
    vocab = params[QWEN][0].vocab
    thresh = sim.COMPACT_THRESHOLD if name.endswith("compact") else None
    log, stats = _ref_log(J.sharded_workload(_spec(J, vocab), HOSTS),
                          compact_threshold=thresh)
    for rank, rep in enumerate(out[0]):
        got = rep["run"]["runs"][name]
        assert got["log"] == log and got["stats"] == stats.as_row(), rank
        assert (got["stats"]["compactions"] > 0) == (thresh is not None)
        assert rep["run"]["rank"] == rank and rep["run"]["mesh"] == [4, 1]


@pytest.mark.parametrize("drill", ["chaos", "overload"])
def test_rank_drill_logs_equal_the_reference_sim(ranks, drill):
    """The kill_host:1@3 and surge plans on 4 hosts' ranks: each rank's
    logs through both transports equal the reference's replay (RECLAIM,
    HOST_DOWN, SHED, DEGRADE included), the drills verified on every
    rank, and one decode step object per width kept its pool."""
    out, params = ranks
    vocab = params[QWEN][0].vocab
    if drill == "chaos":
        log, stats = _ref_log(
            J.sharded_workload(_spec(J, vocab), HOSTS),
            failpoints=J.FailPlan.parse(sim.CHAOS_FAILPOINTS))
        assert stats.host_downs == 1 and stats.requeued >= 1
    else:
        spec = J.LoadSpec(n_requests=3, vocab=vocab, rate=1.0,
                          prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=0)
        p = sim.OVERLOAD_POLICY
        log, stats = _ref_log(
            J.overload_workload(spec, HOSTS,
                                surge_start=sim.OVERLOAD_SURGE_START,
                                surge_factor=sim.OVERLOAD_SURGE_FACTOR,
                                deadline_slack=sim.OVERLOAD_DEADLINE_SLACK),
            failpoints=J.FailPlan.parse(sim.OVERLOAD_FAILPOINTS),
            admission_policy=J.AdmissionPolicy(
                max_queue_depth=p.max_queue_depth,
                pressure_window=p.pressure_window, degrade_lo=p.degrade_lo,
                degrade_hi=p.degrade_hi, restore_below=p.restore_below))
        assert stats.sheds > 0 and stats.degrades >= 2
    for rank, rep in enumerate(out[0]):
        d = rep[drill]
        assert d["verified"] is True
        runs = d["kill_runs"] if drill == "chaos" else d["surge_runs"]
        for tname in ("sim", "collective"):
            assert runs[tname]["log"] == log, (rank, tname)
        inv = d["invariants"]
        assert inv["pool_storage_kept"]
        assert inv["decode_steps_built"] == inv["distinct_stage_steps"]


def test_rank_tokens_equal_the_reference_engine(ranks):
    """Every 4x1 run's tokens on every rank, the chaos drill's fault-free
    twin's among them, equal the reference's single-host Engine on the
    merged workload (8 slots), bit for bit; each rank's pool holds its 2
    slot rows and every kv head."""
    out, params = ranks
    want = _ref_tokens(QWEN, params)
    for rep in out[0]:
        for name in sim.RUNS:
            assert rep["run"]["runs"][name]["tokens"] == want, name
        assert rep["chaos"]["base"]["tokens"] == want
        cfg = params[QWEN][1]
        for layer in rep["run"]["pool_shapes"]:
            assert layer["k"] == [2, sim.MAX_LEN, cfg.num_kv_heads,
                                  cfg.resolved_head_dim]
        inv = rep["run"]["invariants"]
        assert inv["decode_steps_built"] == 1 and inv["pool_storage_kept"]
        st = rep["run"]["prefill_stats"]
        assert st["jobs"] == sum(r["stats"]["prefills"]
                                 for r in rep["run"]["runs"].values())


def _one_process(arch, params, hosts):
    """The compacting run's tokens on one device (the port's one-process
    pool of ``hosts`` simulated hosts) on the same params."""
    _, tcfg, _, sd = params[arch]
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict({n: torch.from_numpy(v) for n, v in sd.items()})
    model.eval().requires_grad_(False)
    return sim.run_compact(cfg=tcfg, model=model, n_hosts=hosts)["tokens"]


@pytest.mark.parametrize("job", [1, 2, 3], ids=["olmoe-4x1", "qwen-2x2",
                                                 "mamba2-2x2"])
def test_rank_compact_runs(ranks, job):
    """One compacting collective run a job: each rank's log equals the
    reference's replay, every rank's tokens equal the reference's
    single-host Engine's on the merged workload of the job's hosts (as
    do the port's one-process pool's on the same params), and each
    rank's pool leaves hold its 2 slot rows and its ``model`` share:
    qwen's 4 kv heads 2 a rank; mamba2's 8 SSD heads 4 a rank and its
    128 ``conv_x`` channels 64 (``conv_b`` / ``conv_c`` whole); olmoe's
    prefill ran on its data shard alone, so the router's collectives
    over ``data`` were not entered."""
    out, params = ranks
    shape, arch, _ = JOBS[job]
    jcfg, tcfg = params[arch][0], params[arch][1]
    hosts, n_model = shape
    log, stats = _ref_log(J.sharded_workload(_spec(J, jcfg.vocab), hosts),
                          compact_threshold=sim.COMPACT_THRESHOLD)
    want = _ref_tokens(arch, params, hosts)
    one = _one_process(arch, params, hosts)
    assert one == want
    for rank, rep in enumerate(out[job]):
        c = rep["compact"]
        assert c["log"] == log and c["stats"] == stats.as_row(), rank
        assert c["stats"]["compactions"] > 0
        assert c["tokens"] == want, rank
        for layer in c["pool_shapes"]:
            if arch == MAMBA:
                m = tcfg.mamba
                heads = m.expand * tcfg.d_model // m.head_dim
                d_in = m.expand * tcfg.d_model
                assert layer["ssm"][:2] == [2, heads // n_model]
                assert layer["conv_x"] == [2, m.d_conv - 1, d_in // n_model]
                assert layer["conv_b"][0] == 2
            else:
                assert layer["k"] == layer["v"] == [
                    2, sim.MAX_LEN, tcfg.num_kv_heads // n_model,
                    tcfg.resolved_head_dim]


def test_serve_sharded_mesh_rank_path_matches_one_device(ranks):
    """``serve --sharded --mesh 2x2``'s rank path (``_sharded_rank``: its
    serving mesh from ``make_serving_mesh(2, 2, transport=...)``, rank
    0's weights sharded over ``model``) returns on rank 0 the tokens and
    schedule of the entry point's one-device run of 2 hosts; the other
    ranks return None."""
    out, _ = ranks
    got = out[len(JOBS)]
    assert got[1:] == [None] * 3
    res, stats = got[0]
    want_res, want_stats = serve.run_sharded(hosts=2, device="cpu",
                                             **SERVE_KW)
    assert {r: v.tokens for r, v in res.items()} == \
        {r: v.tokens for r, v in want_res.items()}
    assert len(res) == 2 * SERVE_KW["requests"]
    assert stats.as_row() == want_stats.as_row()


def test_serving_mesh_over_a_world_takes_its_transport():
    """Over a world of 4 (the ``fake`` backend, rank 3) the serving mesh
    given the world's transport is that world's 2x2 mesh; without a
    transport it is one device's pool of simulated hosts whatever the
    world holds; a shape that is not the world's raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=3,
                                         world_size=4)
    try:
        tr = collectives.Transport("gloo")
        m = t_mesh.make_serving_mesh(2, model_parallel=2, device="cpu",
                                     transport=tr)
        assert m.distributed and m.sizes == (2, 2) and m.transport is tr
        assert m.rank == 3 and m.coords == {"data": 1, "model": 1}
        assert t_mesh.make_serving_mesh(model_parallel=2, device="cpu",
                                        transport=tr).sizes == (2, 2)
        one = t_mesh.make_serving_mesh(8, device="cpu")
        assert not one.distributed and one.sizes == (8, 1)
        with pytest.raises(ValueError, match="world of 8 ranks"):
            t_mesh.make_serving_mesh(4, model_parallel=2, device="cpu",
                                     transport=tr)
    finally:
        torch.distributed.destroy_process_group()


def test_slot_pool_pspecs_at_2x2_follow_the_reference_rule():
    """The pool's specs at (data 2, model 2) for qwen (kv heads split),
    mamba2 (ssm heads and conv_x channels split, conv_b / conv_c not) and
    a config whose kv heads do not divide the axis (replicated), leaf by
    leaf against the reference's ``slot_pool_pspecs`` without its layer
    axis; at model 1 they are the slot axis only."""
    import dataclasses
    for arch, over in ((QWEN, {}), (MAMBA, {}), (QWEN, {"num_kv_heads": 1})):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
        tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
        jdist = j_sharding.DistContext(types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 2}))
        jpool = jax.eval_shape(lambda: j_tf.init_lm_cache(jcfg, 8, 12))
        jspecs = j_sharding.slot_pool_pspecs(jcfg, jpool, jdist, 8)
        want = {}
        for sub in jspecs.values():
            for leaves in sub.values():
                for name, spec in leaves.items():
                    want[name] = tuple(spec)[1:]
        tdist = t_sharding.DistContext(t_mesh.counting_mesh((2, 2)))
        tpool = t_tf.init_lm_cache(tcfg, 8, 12, device="meta")
        got = t_sharding.slot_pool_pspecs(tpool, tdist, 8, tcfg)
        for layer in got:
            for name, spec in layer.items():
                # the port writes a one-axis entry ("data",), JAX "data"
                assert tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in spec) == want[name], (
                    arch, over, name)
        assert any("model" in s for layer in got for s in layer.values()) \
            == (over == {})
        one = t_sharding.DistContext(t_mesh.counting_mesh((2, 1)))
        assert all("model" not in s for layer in
                   t_sharding.slot_pool_pspecs(tpool, one, 8, tcfg)
                   for s in layer.values())
    with pytest.raises(ValueError, match="pass cfg"):
        t_sharding.slot_pool_pspecs(tpool, tdist, 8)


def test_serving_mesh_without_a_world_and_nccl_without_cards():
    """Without a world the serving mesh is one device's, model 1, a model
    axis raises with its reason, and a transport finds no world; nccl with fewer cards than ranks
    raises (nothing falls back to gloo)."""
    assert not torch.distributed.is_initialized()
    m = t_mesh.make_serving_mesh(2, device="cpu")
    assert m.shape == {"data": 2, "model": 1} and not m.distributed
    with pytest.raises(NotImplementedError, match="needs a world"):
        t_mesh.make_serving_mesh(2, model_parallel=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialised"):
        t_mesh.make_serving_mesh(2, device="cpu",
                                 transport=collectives.Transport("gloo"))
    with pytest.raises(ValueError, match="world of ranks"):
        t_mesh.model_mesh(m)
    with pytest.raises(RuntimeError, match="a card per rank"):
        collectives.init_world(0, 2, "tcp://localhost:1", "nccl", "cuda")
    with pytest.raises(SystemExit):
        serve.main(["--arch", QWEN, "--device", "cpu", "--sharded",
                    "--mesh", "2x1", "--transport", "gloo"])


class _LoopbackTransport:
    """A stand-in world for one rank's ``RankGather``: an all-gather
    answers every host's row of its own outbox (``rows``), as the other
    ranks would send it."""

    name = "loopback"

    def __init__(self, rows):
        self.rows = rows
        self.calls = 0

    def all_gather(self, t, group):
        self.calls += 1
        if self.calls % 2:           # the delta exchange: each host's row
            return [torch.as_tensor(r) for r in self.rows()]
        return [t.clone() for _ in range(len(self.rows()))]


def test_corrupted_rank_view_raises_replica_divergence():
    """A rank whose received row for another host differs from its own
    replicated outbox raises ReplicaDivergence in that round, before the
    views reach the transport; unchanged rows run the schedule as the
    loopback does."""
    spec = T.LoadSpec(n_requests=3, vocab=64, rate=1.0, seed=2)
    state = {"buf": None, "round": 0}

    def gather(corrupt_round=None):
        def rows():
            b = state["buf"].copy()
            if state["round"] == corrupt_round:
                b[2, -1, 3] += 1
            return list(b)
        tr = _LoopbackTransport(rows)
        mesh = types.SimpleNamespace(
            distributed=True, shape={"data": 3, "model": 1},
            coords={"data": 0, "model": 0}, device=torch.device("cpu"),
            transport=tr, groups={"data": None})
        g = t_collective.RankGather(mesh)

        def call(buf):
            state["buf"], state["round"] = buf, g.rounds
            return g(buf)
        return g, call

    logs = []
    for corrupt in (None, 2):
        g, call = gather(corrupt)
        transport = T.CollectiveTransport(3, 1, capacity=4, gather=call)
        if corrupt is None:
            sched, _ = T.simulate_sharded_schedule(
                T.sharded_workload(spec, 3), 2, 1, transport=transport)
            logs.append(sim._log_of(sched))
            assert g.rounds > 2
        else:
            with pytest.raises(T.ReplicaDivergence,
                               match=r"round 2.*hosts \[2\]"):
                T.simulate_sharded_schedule(
                    T.sharded_workload(spec, 3), 2, 1, transport=transport)
    sched, _ = T.simulate_sharded_schedule(T.sharded_workload(spec, 3), 2, 1,
                                           transport=T.CollectiveTransport(
                                               3, 1, capacity=4))
    assert logs[0] == sim._log_of(sched)
