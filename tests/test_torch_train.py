"""The LM training slice as a whole: the port's qwen1.5-0.5b smoke model (2
layers, d_model 64, vocab 512, Bloom m 128 k 3, f32) against the JAX
package's, with the reference's params carried over by
``lm_params_from_jax``.

Tolerances: optimizer updates on the same gradients within rtol 1e-6 (the
same f32 operations in the same order; the global norm sums its leaves in
another order); ``lm_loss_fn``'s loss and every parameter's gradient within
1e-4, the reference's own gradient tolerance, against both its
``io_impl="pallas"`` (interpret mode, ``bwd_impl`` "csr" and "dense") and
``"xla"`` paths; a 4-step trajectory of ``launch/train.run`` within rtol 1e-5 of the
reference's ``run``.  Integers are exact: the token stream, the batches and
the data cursor.  The port's own crash and resume equals a straight run
within rtol 1e-6 (``tests/test_checkpoint.py``'s tolerance); a checkpoint
the reference wrote loads into the port, and one the port wrote loads
into the reference."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro.train import trainer as j_trainer
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer, nested
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as t_pipeline
from repro_torch.data import synthetic as t_synthetic
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import trainer as t_trainer

from conftest import subprocess_env

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def ref():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                sd=t_tf.lm_params_from_jax(tree, tcfg))


def _model(ref):
    model = t_tf.TransformerLM(ref["tcfg"])
    model.load_state_dict(ref["sd"])
    return model


@pytest.mark.parametrize("name,wd,warmup,compression", [
    ("adamw", 0.0, 10, "none"),        # the train driver's optimizer
    ("adamw", 0.1, 2, "bf16"),         # decayed weights, compression
    ("adam", 0.0, 0, "none")])         # constant schedule
def test_optimizer_updates_match(name, wd, warmup, compression):
    kw = dict(optimizer=name, learning_rate=3e-3, weight_decay=wd,
              warmup_steps=warmup, grad_compression=compression, steps=6)
    jopt = j_trainer.make_optimizer(JTrainConfig(**kw))
    topt = t_trainer.make_optimizer(TrainConfig(**kw))
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):   # step 1 has lr 0 under warmup
        grads = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp)
        jp = {k: (jp[k] + ju[k]).astype(jp[k].dtype) for k in jp}
        tu, ts = topt.update({k: torch.from_numpy(v)
                              for k, v in grads.items()}, ts, tp)
        tp = t_opt.apply_updates(tp, tu)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_trainer.make_optimizer(TrainConfig(optimizer="lamb"))


@pytest.mark.parametrize("io_impl,bwd_impl,masked", [
    pytest.param("pallas", "csr", False, id="pallas-False"),
    pytest.param("xla", "csr", False, id="xla-False"),
    pytest.param("xla", "csr", True, id="xla-True"),
    pytest.param("pallas", "dense", False, id="pallas-dense-False")])
def test_loss_and_every_gradient_match(ref, io_impl, bwd_impl, masked):
    jcfg = dataclasses.replace(ref["jcfg"], io_impl=io_impl,
                               bwd_impl=bwd_impl)
    tcfg = dataclasses.replace(ref["tcfg"], bwd_impl=bwd_impl)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, size=(2, 16)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if masked:
        mask = np.ones((2, 15), np.float32)
        mask[1, 9:] = 0
        jbatch["loss_mask"] = jnp.asarray(mask)
        tbatch["loss_mask"] = torch.from_numpy(mask)

    def f(p):
        return j_tf.lm_loss_fn(j_steps.cast_params_for_compute(p, jcfg),
                               jcfg, jbatch)

    (jloss, jm), jgrads = jax.value_and_grad(f, has_aux=True)(ref["jparams"])
    model = _model(ref)
    loss, metrics, grads = t_steps.value_and_grad(model, tcfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-4)
    assert float(metrics["ce"]) == float(loss) and float(metrics["aux"]) == 0
    want = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jgrads),
                                   ref["tcfg"])
    assert set(grads) == set(want) == set(dict(model.named_parameters()))
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_trajectory_matches_the_reference_run(ref, monkeypatch):
    """4 steps of launch/train.run (batch 4, seq 16) from the reference's
    params on the same data; the first step has lr 0 under warmup."""
    _, jhist = j_train.run(ARCH, steps=4, batch=4, seq=16, log_every=1)
    monkeypatch.setattr(t_train.steps_lib, "init_fn_for",
                        lambda cfg: lambda seed: _model(ref))
    _, thist = t_train.run(ARCH, steps=4, batch=4, seq=16, log_every=1,
                           device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == [1, 2, 3, 4]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    assert thist[-1]["loss"] < thist[0]["loss"]


@pytest.mark.parametrize("td", ["int8", "bfloat16", "fp8_e4m3"])
def test_quantized_table_trajectory_matches_the_reference_pallas_run(
        ref, monkeypatch, td):
    """The same 4 steps with the embedding table stored as ``td``, against
    the reference's ``io_impl="pallas"`` run: its straight-through
    quantized embedding is the port's (the reference's default XLA path
    fake-quantizes int8 with a gradient at one element per row)."""
    _, jhist = j_train.run(ARCH, steps=4, batch=4, seq=16, log_every=1,
                           io_impl="pallas", table_dtype=td)

    def init_fn_for(cfg):
        assert cfg.table_dtype == td
        model = t_tf.TransformerLM(cfg)
        model.load_state_dict(ref["sd"])
        return lambda seed: model

    monkeypatch.setattr(t_train.steps_lib, "init_fn_for", init_fn_for)
    _, thist = t_train.run(ARCH, steps=4, batch=4, seq=16, log_every=1,
                           table_dtype=td, device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == [1, 2, 3, 4]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    assert thist[-1]["loss"] < thist[0]["loss"]


def test_token_stream_and_batches_are_equal():
    js = j_synthetic.make_token_stream(5000, 512, seed=3)
    ts = t_synthetic.make_token_stream(5000, 512, seed=3)
    assert ts.dtype == js.dtype and np.array_equal(ts, js)
    jw, tw = j_pipeline.lm_batches(js, 4, 16), t_pipeline.lm_batches(ts, 4, 16)
    assert np.array_equal(jw, tw)
    jit = j_pipeline.BatchIterator([jw], 4, seed=3)
    tit = t_pipeline.BatchIterator([tw], 4, seed=3)
    for _ in range(len(tw) // 4 + 3):      # across an epoch boundary
        assert np.array_equal(next(jit)[0], next(tit)[0])
        assert jit.state() == tit.state()
    tit2 = t_pipeline.BatchIterator([tw], 4, seed=0)
    tit2.restore(jit.state())
    assert np.array_equal(next(jit)[0], next(tit2)[0])


def test_crash_and_resume_equal_a_straight_run(tmp_path):
    kw = dict(steps=24, batch=4, seq=16, log_every=1, device="cpu")
    straight, hist = t_train.run(ARCH, **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="induced fault at step 15"):
        t_train.run(ARCH, ckpt_dir=ck, failpoints="train_fault@15", **kw)
    assert Checkpointer(ck).all_steps() == [10]
    resumed, rhist = t_train.run(ARCH, ckpt_dir=ck, **kw)
    assert [h["step"] for h in rhist] == list(range(11, 25))
    np.testing.assert_allclose([h["loss"] for h in rhist],
                               [h["loss"] for h in hist[10:]], rtol=1e-6)
    for (name, a), b in zip(straight.named_parameters(),
                            resumed.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, err_msg=name)
    assert Checkpointer(ck).all_steps() == [10, 20, 24]


def test_checkpoints_cross_between_the_packages(ref, tmp_path):
    jck = JCheckpointer(str(tmp_path / "jax"))
    jck.save(7, {"params": ref["jparams"]}, extra={"data": {"cursor": 3}})
    ck = Checkpointer(str(tmp_path / "jax"))
    flat, extra = ck.read(ck.all_steps()[-1])
    sd = t_tf.lm_params_from_jax(nested(flat)["params"], ref["tcfg"])
    assert extra == {"data": {"cursor": 3}} and sd.keys() == ref["sd"].keys()
    for name, t in sd.items():
        assert torch.equal(t, ref["sd"][name]), name

    model = _model(ref)
    opt = t_trainer.make_optimizer(TrainConfig(optimizer="adamw"))
    state = {"params": dict(model.named_parameters()),
             "opt_state": opt.init(ref["sd"])}
    Checkpointer(str(tmp_path / "port")).save(3, state)
    template = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                            {"params": ref["sd"]})
    restored, step, _ = JCheckpointer(str(tmp_path / "port")).restore_latest(
        template)
    assert step == 3
    for name, t in ref["sd"].items():
        assert np.array_equal(np.asarray(restored["params"][name]), t.numpy())
    got, step, _ = Checkpointer(str(tmp_path / "port")).restore_latest(
        {"params": {n: torch.zeros_like(p) for n, p in ref["sd"].items()},
         "opt_state": opt.init(ref["sd"])})
    assert step == 3 and int(got["opt_state"][1]["count"]) == 0


def test_train_cli_on_the_cpu(tmp_path):
    root = Path(__file__).resolve().parents[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "16",
           "--ckpt", str(tmp_path)]
    out = [subprocess.run(cmd, cwd=root, env=subprocess_env(),
                          capture_output=True, text=True, timeout=120)
           for _ in range(2)]
    assert out[0].returncode == 0, out[0].stderr
    assert "step    10  loss" in out[0].stdout
    assert "trained 12 steps" in out[0].stdout
    assert out[1].returncode == 0, out[1].stderr
    assert "resumed from step 12" in out[1].stdout
    assert "trained 0 steps" in out[1].stdout
    dense = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "16",
         "--bwd-impl", "dense"],
        cwd=root, env=subprocess_env(), capture_output=True, text=True,
        timeout=120)
    assert dense.returncode == 0, dense.stderr
    assert "trained 12 steps" in dense.stdout
    # the dense backward adds in the CSR kernel's order: the same losses

    def losses(stdout):
        return [ln.split()[3] for ln in stdout.splitlines()
                if ln.startswith("step")]

    assert losses(dense.stdout) == losses(out[0].stdout) != []
    with pytest.raises(SystemExit):     # argparse: not a knob value
        t_train.main(["--arch", ARCH, "--device", "cpu", "--bwd-impl",
                      "sparse"])
    with pytest.raises(SystemExit):     # argparse: not a knob value
        t_train.main(["--arch", ARCH, "--device", "cpu", "--table-dtype",
                      "int4"])
