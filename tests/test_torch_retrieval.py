"""The retrieval serving slice as a whole: the port's RetrievalEngine
(repro_torch.serving.retrieval) against the JAX package's on the smoke
preset, 4 slots, 10 requests, with the reference's tower weights loaded
into the port (params_from_jax).

Integers are exact: the workload, the slot event logs, decode steps, the
ServeStats counters and the modeled bytes.  Floats: tower logits within
1e-5 and top-k scores within 1e-4, because f32 matmul and log_softmax sum
in another order in the two libraries; top-k ids equal, except where the
reference's own Eq. 3 scores of the two ids are within 1e-4 (a near-tie).
Also: the degrade ladder serves prefixes, replays are bit-identical, the
ranking eval agrees within 1e-6, and importing the port loads no JAX."""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_retrieval_config as j_config
from repro.core import bloom as jb
from repro.launch import steps as j_steps
from repro.serving import loadgen as j_loadgen
from repro.serving import retrieval as j_ret
from repro.serving.admission import AdmissionPolicy as JPolicy
from repro.serving.failpoints import FailPlan as JFailPlan
from repro_torch.configs.retrieval import get_retrieval_config as t_config
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import common
from repro_torch.launch import steps as t_steps
from repro_torch.models.recommender import params_from_jax
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.serving import engine as t_engine
from repro_torch.serving import retrieval as t_ret
from repro_torch.serving.admission import AdmissionPolicy as TPolicy
from repro_torch.serving.admission import stage_topk
from repro_torch.serving.failpoints import FailPlan as TFailPlan

from conftest import assert_slot_log_sound, subprocess_env

N_SLOTS, N_REQ = 4, 10


def _load(mod, rcfg):
    return mod.RetrievalLoadSpec(n_requests=N_REQ, catalog=rcfg.d,
                                 c_max=rcfg.c_max, rate=2.0, seed=0)


def _stats(st):
    return {f: getattr(st, f) for f in (
        "decode_steps", "idle_steps", "slot_steps_total",
        "slot_steps_active", "prefills", "tokens_out", "compactions",
        "host_downs", "requeued", "rejects", "sheds", "degrades")}


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = j_config("smoke"), t_config("smoke")
    jparams = j_ret.init_retrieval_params(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(tree, "cpu")
    jwl = j_loadgen.retrieval_workload(_load(j_loadgen, jcfg))
    twl = t_loadgen.retrieval_workload(_load(t_loadgen, tcfg))
    jeng = j_ret.RetrievalEngine(jcfg, jparams, n_slots=N_SLOTS)
    teng = t_ret.RetrievalEngine(tcfg, tparams, n_slots=N_SLOTS)
    jres, jst = jeng.run([r.fresh_copy() for r in jwl])
    common.reset_launches()
    tres, tst = teng.run([r.fresh_copy() for r in twl])
    launches = common.LAUNCHES.get(dt.NAME, 0)
    tres_b, tst_b = teng.run([r.fresh_copy() for r in twl])
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jwl=jwl, twl=twl, jeng=jeng, teng=teng, jres=jres, jst=jst,
                tres=tres, tst=tst, tres_b=tres_b, tst_b=tst_b,
                launches=launches)


def test_config_presets_match_the_reference():
    from repro.configs.retrieval import RETRIEVAL_CONFIGS as J
    from repro_torch.configs.retrieval import RETRIEVAL_CONFIGS as T
    assert set(J) == set(T)
    for name in J:
        want = {f: getattr(J[name], f) for f in J[name].__dataclass_fields__
                if f != "impl"}      # the port resolves its path by device
        got = {f: getattr(T[name], f) for f in T[name].__dataclass_fields__}
        assert got == want, name
    assert t_config("smoke", table_dtype="int8").table_dtype == "int8"
    with pytest.raises(ValueError, match="table_dtype must be one of"):
        t_config("smoke", table_dtype="f16")


def test_workload_is_the_reference_workload(both):
    for jr, tr in zip(both["jwl"], both["twl"], strict=True):
        assert (jr.rid, jr.arrival_step, jr.kind, jr.max_gen) == \
            (tr.rid, tr.arrival_step, tr.kind, tr.max_gen)
        np.testing.assert_array_equal(jr.prompt, tr.prompt)
        np.testing.assert_array_equal(jr.targets, tr.targets)


def test_schedule_logs_and_stats_equal_the_reference(both):
    assert both["teng"]._sched.admissions == both["jeng"]._sched.admissions
    assert both["teng"]._sched.releases == both["jeng"]._sched.releases
    assert _stats(both["tst"]) == _stats(both["jst"])
    mb_t, mb_j = both["teng"].modeled_bytes, both["jeng"].modeled_bytes
    for key in mb_j:
        assert mb_t[key] == mb_j[key], key
    assert_slot_log_sound(both["teng"]._sched, N_SLOTS)
    assert both["launches"] == 0            # CPU tensors: the plain version


def test_tower_logits_close(both):
    prompts = np.full((N_REQ, both["jcfg"].c_max), -1, np.int32)
    for i, r in enumerate(both["jwl"]):
        prompts[i, :r.prompt_len] = r.prompt
    want = np.asarray(j_steps.make_retrieval_prefill_step(both["jcfg"])(
        both["jparams"], jnp.asarray(prompts)))
    got = t_steps.make_retrieval_prefill_step(both["tcfg"])(
        both["tparams"], torch.from_numpy(prompts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _reference_scores(jcfg, jparams, prompt, ids):
    """The reference's own Eq. 3 scores of ``ids`` for one request."""
    items = np.full((1, jcfg.c_max), -1, np.int32)
    items[0, :len(prompt)] = prompt
    logits = j_steps.make_retrieval_prefill_step(jcfg)(jparams,
                                                        jnp.asarray(items))
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jb.decode_scores(jcfg.spec(), logp,
                                       item_ids=jnp.asarray(ids, jnp.int32)))[0]


def test_topk_ids_and_scores_match_the_reference(both):
    for rid, jr in both["jres"].items():
        tr = both["tres"][rid]
        assert tr.done and not tr.rejected and tr.tokens == [tr.topk_ids[0]]
        assert (tr.admitted_step, tr.finish_step, tr.slot) == \
            (jr.admitted_step, jr.finish_step, jr.slot)
        np.testing.assert_allclose(tr.topk_scores, jr.topk_scores,
                                   rtol=0, atol=1e-4)
        # the reference's own scores of the port's ids equal its top-k
        # scores, so an id that differs at a position is a near-tie there
        np.testing.assert_allclose(
            _reference_scores(both["jcfg"], both["jparams"], jr.prompt,
                              tr.topk_ids),
            jr.topk_scores, rtol=0, atol=1e-4)
        for pos, (ti, ji) in enumerate(zip(tr.topk_ids, jr.topk_ids)):
            if ti != ji:
                assert ti in jr.topk_ids or pos == len(jr.topk_ids) - 1


def test_replays_bit_identical(both):
    for rid, ra in both["tres"].items():
        rb = both["tres_b"][rid]
        assert ra.topk_ids == rb.topk_ids
        assert ra.topk_scores == rb.topk_scores
    assert _stats(both["tst"]) == _stats(both["tst_b"])


def test_eval_metrics_match_the_reference(both):
    want = j_ret.evaluate_retrieval(both["jcfg"], both["jparams"],
                                    list(both["jres"].values()))
    got = t_ret.evaluate_retrieval(both["tcfg"], both["tparams"],
                                   list(both["tres"].values()))
    assert got["n_evaluated"] == want["n_evaluated"] == N_REQ
    for key in ("map", "rr", "accuracy"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key


def test_prefill_faults_retry_then_reject_like_the_reference(both):
    """Request 0 fails every prefill attempt (rejected), request 1 fails
    once (retried on the next worker): the same outcome on both engines."""
    spec = "fail_prefill:0:3,fail_prefill:1:1"
    runs = {}
    for name, mod, cfg, params, wl, plan in [
            ("j", j_ret, both["jcfg"], both["jparams"], both["jwl"],
             JFailPlan),
            ("t", t_ret, both["tcfg"], both["tparams"], both["twl"],
             TFailPlan)]:
        eng = mod.RetrievalEngine(cfg, params, n_slots=N_SLOTS,
                                  prefill_workers=2,
                                  failpoints=plan.parse(spec))
        res, st = eng.run([r.fresh_copy() for r in wl])
        runs[name] = (res, st, eng.prefill_pool.stats)
    (jres, jst, jpool), (tres, tst, tpool) = runs["j"], runs["t"]
    assert _stats(tst) == _stats(jst) and tst.rejects == 1
    assert tpool == jpool and tpool["retries"] == 4
    assert tres[0].rejected and not tres[1].rejected
    for rid, jr in jres.items():
        assert tres[rid].rejected == jr.rejected
        if not jr.rejected:
            assert tres[rid].topk_ids == jr.topk_ids


def test_prefill_error_that_is_not_injected_propagates(both, monkeypatch):
    def broken(self, req):
        raise RuntimeError("device error in the tower")

    monkeypatch.setattr(t_engine.PrefillWorker, "prefill", broken)
    eng = t_ret.RetrievalEngine(both["tcfg"], both["tparams"],
                                n_slots=N_SLOTS)
    with pytest.raises(RuntimeError, match="device error"):
        eng.run([r.fresh_copy() for r in both["twl"]])


def test_degraded_stages_serve_prefixes_like_the_reference(both):
    """The overload ladder (surge + slow decode) on both engines: the same
    sheds and degrade transitions, and every degraded request's ids a
    prefix of its full-width ids."""
    runs = {}
    for name, mod, eng, cfg, params, policy_cls, plan in [
            ("j", j_ret, j_ret.RetrievalEngine, both["jcfg"],
             both["jparams"], JPolicy, JFailPlan),
            ("t", t_ret, t_ret.RetrievalEngine, both["tcfg"],
             both["tparams"], TPolicy, TFailPlan)]:
        wl = [r.fresh_copy() for r in both[name + "wl"]]
        for r in wl:
            r.deadline_step = r.arrival_step + 6
        policy = policy_cls(max_queue_depth=2, pressure_window=2,
                            degrade_lo=0.25, degrade_hi=0.5,
                            restore_below=0.1)
        engine = eng(cfg, params, n_slots=2,
                     failpoints=plan.parse("surge:3@1,slow_decode:3@2"),
                     admission_policy=policy)
        runs[name] = engine.run(wl) + (engine, policy)
    (jres, jst, _, _), (tres, tst, teng, policy) = runs["j"], runs["t"]
    assert _stats(tst) == _stats(jst)
    assert tst.sheds > 0 and tst.degrades >= 1
    widths = set()
    for rid, r in tres.items():
        assert r.shed == jres[rid].shed
        if r.shed:
            assert not r.topk_ids
            continue
        k = len(r.topk_ids)
        widths.add(k)
        assert k == len(jres[rid].topk_ids)
        assert r.topk_ids == both["tres"][rid].topk_ids[:k]
    assert len(widths) > 1
    assert widths <= {stage_topk(both["tcfg"].topk, s, policy)
                      for s in range(policy.max_stage + 1)}
    assert teng.program._stage == 0
    assert_slot_log_sound(teng._sched, teng.n_slots)


def test_drill_runs_on_cpu():
    report = t_ret._drill(t_config("smoke"), 8, 4, 0, "cpu")
    want = j_ret._drill(j_config("smoke"), 8, 4, 0)
    assert report["impl"] == "plain" and report["device"] == "cpu"
    for key in ("decode_steps", "utilization", "dense_oracle_bytes"):
        assert report[key] == want[key], key
    assert report["tpu_grid_modeled_bytes"] == want["streaming_bytes"]


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "for name in ('serving.retrieval', 'serving.engine', "
        "'launch.serve', 'kernels.bloom_embed', 'models.transformer', "
        "'configs.qwen1_5_0_5b', 'launch.train', 'kernels.bloom_ce', "
        "'kernels.bloom_csr', 'core.losses', 'optim.optimizers', "
        "'train.trainer', 'checkpoint.checkpointer', 'data.pipeline', "
        "'data.synthetic', 'kernels.bloom_decode', 'core.alternatives', "
        "'train.retrieval_trainer', 'launch.train_retrieval', "
        "'benchmarks.bench_retrieval'):\n"
        "    assert 'repro_torch.' + name in sys.modules, name\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=subprocess_env(),
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", smoke, re.M)
    assert imports and not [m for m in imports if m.split(".")[0] in
                            ("jax", "jaxlib", "repro")], imports
