"""Retrieval training, the port's train -> serve -> eval loop
(``repro_torch.train.retrieval_trainer``, ``train/trainer.py``,
``launch/train_retrieval.py``, ``benchmarks/bench_retrieval.py``) against
the JAX package's, at eval2k (d = 2,000, k = 2, hidden (32,)).

The reference's params come across through ``params_from_jax`` or through
its npz + JSON checkpoint read by the port's ``Checkpointer``.
Tolerances: the loss, ``target_mass`` and every gradient within 1e-4 (the
reference's gradient tolerance); microbatch 1 and 4 within rtol 1e-5 /
atol 1e-6 (``tests/test_retrieval_train.py``); a 30-step Trainer history
within rtol 1e-5 of the reference Trainer's; a resumed run within rtol
1e-6 of a straight one (``tests/test_checkpoint.py``).  Integers are
exact: the dataset, the served top-k ids of reference-trained params,
the bench's integer fields."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.retrieval import get_retrieval_config as j_config
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.models import recommender as j_rec
from repro.serving import loadgen as j_loadgen
from repro.serving import retrieval as j_ret
from repro.train import retrieval_trainer as j_rt
from repro.train import trainer as j_trainer
from repro_torch.benchmarks import bench_retrieval as bench
from repro_torch.checkpoint.checkpointer import Checkpointer, nested
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.retrieval import get_retrieval_config as t_config
from repro_torch.data.pipeline import BatchIterator
from repro_torch.models import recommender as t_rec
from repro_torch.models.recommender import params_from_jax
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.serving import retrieval as t_ret
from repro_torch.train import retrieval_trainer as t_rt
from repro_torch.train import trainer as t_trainer

from conftest import subprocess_env

ROOT = Path(__file__).resolve().parents[1]


def _np_tree(jparams):
    return jax.tree.map(np.asarray, jparams)


def _jax_grads_as_port(grads, tower):
    """The reference's {"l{i}": {"w" (in, out), "b"}} gradients in the
    port's named_parameters order and (out, in) layout."""
    out = {}
    for i in range(len(tower.layers)):
        out[f"layers.{i}.weight"] = np.asarray(grads[f"l{i}"]["w"]).T
        out[f"layers.{i}.bias"] = np.asarray(grads[f"l{i}"]["b"])
    return out


def _assert_tower_equals_tree(tower, tree, rtol, atol=0.0):
    for i, layer in enumerate(tower.layers):
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(tree[f"l{i}"]["w"]).T,
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(tree[f"l{i}"]["b"]),
                                   rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def init():
    """The reference's eval2k init params, as a numpy tree."""
    return _np_tree(j_ret.init_retrieval_params(j_config("eval2k")))


def test_loss_target_mass_and_every_gradient_match(init):
    jcfg, tcfg = j_config("eval2k"), t_config("eval2k")
    p, q = j_rt.make_retrieval_dataset(jcfg, 64, seed=3)
    jbatch = {"p": jnp.asarray(p), "q": jnp.asarray(q)}
    tbatch = {"p": torch.from_numpy(p), "q": torch.from_numpy(q)}
    (jloss, jm), jg = jax.value_and_grad(
        j_rt.make_retrieval_loss(jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, init), jbatch)

    tower = params_from_jax(init, "cpu")
    tloss, tm = t_rt.make_retrieval_loss(tcfg)(tower, tbatch)
    names = [n for n, _ in tower.named_parameters()]
    tg = dict(zip(names, torch.autograd.grad(tloss, list(
        tower.parameters()))))
    tloss = tloss.detach()
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["target_mass"]),
                               float(jm["target_mass"]), atol=1e-4,
                               rtol=1e-4)
    want = _jax_grads_as_port(jg, tower)
    assert set(want) == set(tg)
    for name in names:
        np.testing.assert_allclose(tg[name].numpy(), want[name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    assert any(np.abs(g).max() > 1e-3 for g in want.values())

    # recommender_loss on its own, over the same serving-spec embedding
    jemb, temb = j_rt.make_retrieval_emb(jcfg), t_rt.make_retrieval_emb(tcfg)
    jl = j_rec.recommender_loss(jax.tree.map(jnp.asarray, init), jemb,
                                jbatch["p"], jbatch["q"])
    tl = t_rec.recommender_loss(tower, temb, tbatch["p"],
                                tbatch["q"]).detach()
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=1e-4)
    assert float(tl) == pytest.approx(float(tloss), rel=1e-6)
    js = j_rec.recommender_scores(jax.tree.map(jnp.asarray, init), jemb,
                                  jbatch["p"][:4])
    ts = t_rec.recommender_scores(tower, temb, tbatch["p"][:4])
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               atol=1e-4, rtol=1e-4)


def test_recommender_init_is_an_fftower_of_the_embedding():
    emb = t_rt.make_retrieval_emb(t_config("eval2k"))
    tower = t_rec.recommender_init(emb, (32,), torch.Generator().manual_seed(
        0), device="cpu")
    assert [tuple(p.shape) for p in tower.parameters()] == \
        [(32, 400), (32,), (400, 32), (400,)]


def test_dataset_is_the_reference_dataset():
    jcfg, tcfg = j_config("eval2k"), t_config("eval2k")
    for seed, n in ((0, 512), (7, 33)):
        jp, jq = j_rt.make_retrieval_dataset(jcfg, n, seed=seed)
        tp, tq = t_rt.make_retrieval_dataset(tcfg, n, seed=seed)
        assert tp.dtype == jp.dtype and tq.dtype == jq.dtype
        assert np.array_equal(tp, jp) and np.array_equal(tq, jq)


def test_loss_uses_the_serving_spec_on_both_sides():
    tcfg = t_config("eval2k")
    emb = t_rt.make_retrieval_emb(tcfg)
    assert emb.spec_in == emb.spec_out == tcfg.spec()
    jspec = j_rt.make_retrieval_emb(j_config("eval2k")).spec_out
    assert (emb.spec_out.d, emb.spec_out.m, emb.spec_out.k,
            emb.spec_out.seed) == (jspec.d, jspec.m, jspec.k, jspec.seed)


def test_microbatch_metric_parity():
    """microbatch 4 reports the metrics and gives the params of
    microbatch 1 on the same batch (the reference's fixed trainer bug:
    per-chunk metrics are averaged, not the last chunk's kept), and equals
    the reference's microbatch-4 step."""
    jcfg = j_config("eval2k", m=200)
    tcfg = t_config("eval2k", m=200)
    p, q = j_rt.make_retrieval_dataset(jcfg, 16, seed=3)
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.0,
              grad_clip_norm=0.0, warmup_steps=0)
    tree = _np_tree(j_ret.init_retrieval_params(jcfg))
    tx = t_trainer.make_optimizer(TrainConfig(**kw))
    loss_fn = t_rt.make_retrieval_loss(tcfg)
    batch = {"p": torch.from_numpy(p), "q": torch.from_numpy(q)}
    towers, metrics = [], []
    for mb in (1, 4):
        tower = params_from_jax(tree, "cpu")
        step = t_trainer.make_train_step(loss_fn, tx, microbatch=mb)
        _, m = step(tower, tx.init(dict(tower.named_parameters())), batch)
        towers.append(tower)
        metrics.append({k: float(v) for k, v in m.items()})
    assert set(metrics[0]) == set(metrics[1]) == \
        {"loss", "grad_norm", "target_mass"}
    for key in sorted(metrics[0]):
        np.testing.assert_allclose(metrics[1][key], metrics[0][key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for a, b in zip(towers[0].parameters(), towers[1].parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)

    jtx = j_trainer.make_optimizer(JTrainConfig(**kw))
    jp0 = jax.tree.map(jnp.asarray, tree)
    jp1, _, jm = j_trainer.make_train_step(
        j_rt.make_retrieval_loss(jcfg), jtx, microbatch=4, donate=False)(
        jp0, jtx.init(jp0), {"p": jnp.asarray(p), "q": jnp.asarray(q)})
    for key in sorted(metrics[1]):
        np.testing.assert_allclose(metrics[1][key], float(jm[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    _assert_tower_equals_tree(towers[1], _np_tree(jp1), rtol=1e-5,
                              atol=1e-6)


def test_trainer_history_matches_the_reference_trainer(init):
    """30 Trainer steps from the reference's init params, the retrieval
    loss, adamw with warmup and clipping, the same seeded batches: every
    step's loss, grad_norm and target_mass within rtol 1e-5."""
    jcfg, tcfg = j_config("eval2k"), t_config("eval2k")
    p, q = j_rt.make_retrieval_dataset(jcfg, 256, seed=0)
    kw = dict(optimizer="adamw", learning_rate=3e-2, grad_clip_norm=1.0,
              steps=30, warmup_steps=10, checkpoint_every=0)
    jtrainer = j_trainer.Trainer(
        j_rt.make_retrieval_loss(jcfg), jax.tree.map(jnp.asarray, init),
        JTrainConfig(**kw), JBatchIterator([p, q], 64, seed=0),
        make_batch=lambda a: {"p": jnp.asarray(a[0]),
                              "q": jnp.asarray(a[1])})
    ttrainer = t_trainer.Trainer(
        t_rt.make_retrieval_loss(tcfg), params_from_jax(init, "cpu"),
        TrainConfig(**kw), BatchIterator([p, q], 64, seed=0),
        make_batch=lambda a: {"p": torch.from_numpy(a[0]),
                              "q": torch.from_numpy(a[1])})
    jr, tr = jtrainer.run(log_every=1), ttrainer.run(log_every=1)
    assert tr["steps"] == jr["steps"] == 30
    assert [h["step"] for h in tr["history"]] == list(range(1, 31))
    for key in ("loss", "grad_norm", "target_mass"):
        np.testing.assert_allclose([h[key] for h in tr["history"]],
                                   [h[key] for h in jr["history"]],
                                   rtol=1e-5, err_msg=key)
    assert tr["history"][-1]["loss"] < tr["history"][0]["loss"]


def test_crash_and_resume_equal_a_straight_run(tmp_path):
    """train_fault@6, then a resume in a new Trainer, equals a straight
    12-step run: params within rtol 1e-6 and the whole history (restored
    from the checkpoint's extra, then appended)."""
    rcfg = t_config("eval2k")
    tc = t_rt.default_train_config(steps=12, checkpoint_every=3)
    kw = dict(n_pairs=128, batch_size=32, log_every=2, device="cpu")
    straight, r1 = t_rt.train_retrieval(
        rcfg, tc, checkpoint_dir=str(tmp_path / "a"), **kw)
    ck = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="induced fault at step 6"):
        t_rt.train_retrieval(rcfg, tc, checkpoint_dir=ck,
                             failpoints="train_fault@6", **kw)
    assert Checkpointer(ck).all_steps() == [3, 6]
    resumed, r3 = t_rt.train_retrieval(rcfg, tc, checkpoint_dir=ck, **kw)
    assert [h["step"] for h in r3["history"]] == \
        [h["step"] for h in r1["history"]] == [2, 4, 6, 8, 10, 12]
    np.testing.assert_allclose([h["loss"] for h in r3["history"]],
                               [h["loss"] for h in r1["history"]],
                               rtol=1e-6)
    for a, b in zip(straight.parameters(), resumed.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6)
    assert Checkpointer(ck).all_steps() == [6, 9, 12]


def test_reference_trained_params_serve_the_same_ids(tmp_path):
    """The reference trains eval2k at 1/5 for 100 steps and writes its
    checkpoint; the port reads it, serves 64 eval requests through its
    RetrievalEngine, and serves the reference engine's top-k ids; MAP and
    RR within 1e-6.  The int8 dual-eval MAP is held to the bench's gate
    (>= 0.9 of the f32 MAP), not to 1e-6: its scores are sums of int8
    levels times a row scale, which tie in blocks where the int sums tie,
    and the scale moves by an ulp with the logp (torch and XLA sum the
    tower's matmuls in another order), which reorders those ties."""
    jcfg, tcfg = j_config("eval2k"), t_config("eval2k")
    ck = str(tmp_path / "ref")
    jparams, _ = j_rt.train_retrieval(
        jcfg, j_rt.default_train_config(steps=100, checkpoint_every=50),
        checkpoint_dir=ck)
    reader = Checkpointer(ck)
    assert reader.all_steps()[-1] == 100
    flat, extra = reader.read(100)
    assert [h["step"] for h in extra["history"]] == list(range(10, 101, 10))
    tower = params_from_jax(nested(flat)["params"], "cpu")
    _assert_tower_equals_tree(tower, _np_tree(jparams), rtol=0.0)

    def load(mod, cfg):
        return mod.RetrievalLoadSpec(n_requests=64, catalog=cfg.d,
                                     c_max=cfg.c_max, rate=2.0, seed=1)
    jwl = [r.fresh_copy() for r in
           j_loadgen.retrieval_workload(load(j_loadgen, jcfg))]
    twl = [r.fresh_copy() for r in
           t_loadgen.retrieval_workload(load(t_loadgen, tcfg))]
    jres, jst = j_ret.RetrievalEngine(jcfg, jparams, n_slots=8).run(jwl)
    tres, tst = t_ret.RetrievalEngine(tcfg, tower, n_slots=8).run(twl)
    assert tst.decode_steps == jst.decode_steps
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        assert tres[rid].topk_ids == jres[rid].topk_ids, rid
    jev = j_ret.evaluate_retrieval(jcfg, jparams, list(jres.values()))
    tev = t_ret.evaluate_retrieval(tcfg, tower, list(tres.values()))
    assert tev["n_evaluated"] == jev["n_evaluated"] == 64
    for key in ("map", "rr", "accuracy"):
        assert tev[key] == pytest.approx(jev[key], abs=1e-6), key
    want = j_rt.serve_and_eval(jcfg, jparams)
    got = t_rt.serve_and_eval(tcfg, tower)
    assert got["decode_steps"] == want["decode_steps"]
    for key in ("map", "rr"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert got["map_int8"] >= 0.9 * got["map"]
    assert got["map"] > 3 * t_rt.serve_and_eval(
        tcfg, t_ret.init_retrieval_params(tcfg, device="cpu"))["map"]


def test_train_retrieval_cli_crash_and_resume(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train_retrieval",
           "--device", "cpu", "--steps", "60", "--pairs", "256",
           "--eval-requests", "16", "--slots", "4", "--ckpt",
           str(tmp_path / "ck"), "--checkpoint-every", "20",
           "--out", str(tmp_path / "report.json")]
    crash = subprocess.run(cmd + ["--fault-at", "30"], cwd=ROOT,
                           env=subprocess_env(), capture_output=True,
                           text=True, timeout=120)
    assert crash.returncode != 0
    assert "induced fault at step 30" in crash.stderr
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [20]
    out = subprocess.run(cmd, cwd=ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "retrieval-train: verified (eval2k: d=2000, 60 steps on cpu" \
        in out.stdout
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["verified"] and report["point"]["steps"] == 60
    assert report["point"]["n_evaluated"] == 16


@pytest.fixture(scope="module")
def sweep():
    """The bench's sweep, once per module (~10 s on the CPU)."""
    return bench.run_sweep("cpu")


def test_bench_twin_check_passes(sweep):
    assert [r["name"] for r in sweep] == [
        f"retrieval_train.eval2k_r{r}" for r in (1, 2, 5, 10)]
    assert bench.check_against(sweep) == []
    committed = {r["name"]: r for r in json.loads(
        (ROOT / "BENCH_retrieval.json").read_text())["rows"]}
    for r in sweep:
        for f in ("d", "m", "k", "steps", "n_train_pairs", "n_evaluated",
                  "decode_steps"):
            assert r[f] == committed[r["name"]][f], (r["name"], f)


def test_bench_twin_gates_and_writes_only_its_snapshot(sweep, tmp_path,
                                                       monkeypatch, capsys):
    bench_file = ROOT / "BENCH_retrieval.json"
    before = bench_file.read_bytes()
    monkeypatch.setattr(bench, "run_sweep", lambda device: [
        dict(r) for r in sweep])
    out = tmp_path / "snap.json"
    bench.main(["--check", "--device", "cpu", "--out", str(out)])
    assert "check ok: 4 rows on cpu" in capsys.readouterr().out
    assert json.loads(out.read_text())["rows"] == sweep
    assert bench_file.read_bytes() == before
    # a drifted integer or a failed gate exits non-zero
    bad = [dict(r) for r in sweep]
    bad[0]["decode_steps"] += 1
    assert any("decode_steps" in f for f in bench.check_against(bad))
    flat = [dict(r, map=r["untrained_map"]) for r in sweep]
    assert bench.gate_margins(flat)
    monkeypatch.setattr(bench, "run_sweep", lambda device: flat)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu"])
    assert exc.value.code == 1
