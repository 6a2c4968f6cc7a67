"""The parallel training step over real ranks: four CPU processes over gloo,
started by ``launch/train.spawn`` (torch.multiprocessing), each holding its
shards of the weights, against the JAX package's single-device steps on
the same weights and data.

Tolerances, with their reasons: the ranks sum the row-parallel products,
the vocab-parallel embedding and the loss's hit sums in another order
than one device does (and gloo's all-reduce in yet another), so losses
are held within rtol 1e-5 and gradients within 1e-4 (the reference's
own gradient tolerance), not bit for bit.  A checkpoint resumed on
another mesh gives the next loss of the one-process resume within rtol
1e-6 (``tests/test_checkpoint.py``'s tolerance for resumed training).

Each test bounds its ranks' runs (``spawn``'s ``timeout``, the time left
of 85 s from the test's start) so that it ends within 90 s or fails."""
import dataclasses
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt

TC = dict(optimizer="adamw", learning_rate=3e-3, grad_clip_norm=1.0,
          warmup_steps=0, weight_decay=0.1)


def _deadline():
    """Seconds left, from each call, of the test's 85 s."""
    end = time.monotonic() + 85.0
    return lambda: max(end - time.monotonic(), 1.0)


def _reference_params(jcfg, tcfg):
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0))
    return jparams, t_tf.lm_params_from_jax(jax.tree.map(np.asarray,
                                                         jparams), tcfg)


def test_dense_step_on_2x2_and_1x4_matches_the_single_device_reference():
    """qwen3-4b smoke (f32; 4 heads, 2 kv heads, untied Bloom head, m 128)
    3 steps on mesh 2x2 (kv heads split) and 1x4 (kv heads replicated
    over the 4-way model axis), from the reference's weights: the losses
    within rtol 1e-5 of the reference's ``make_train_step`` and, on 2x2,
    the first step's gathered gradients within 1e-4 of ``jax.grad`` (the
    global norm is above the clip threshold, so a norm that counted the
    replicated leaves once per model rank would move every step)."""
    left = _deadline()
    arch = "qwen3-4b"
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jparams, sd = _reference_params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, size=(8, 17))
                .astype(np.int32)} for _ in range(3)]

    jstep, jopt = j_steps.make_train_step(jcfg, JTrainConfig(**TC))

    def jloss(p):
        return j_tf.lm_loss_fn(j_steps.cast_params_for_compute(p, jcfg),
                               jcfg, {"tokens": jnp.asarray(
                                   batches[0]["tokens"])})[0]

    jgrads = t_tf.lm_params_from_jax(
        jax.tree.map(np.asarray, jax.grad(jloss)(jparams)), tcfg)
    assert float(t_opt.global_norm(jgrads)) > TC["grad_clip_norm"]
    params, state, want = jparams, jopt.init(jparams), []
    for b in batches:
        params, state, m = jstep(params, state,
                                 {"tokens": jnp.asarray(b["tokens"])})
        want.append(float(m["loss"]))

    sd_np = {n: t.numpy() for n, t in sd.items()}
    for shape in ((2, 2), (1, 4)):
        outs = t_train.spawn(t_train.train_job, shape, "gloo", "cpu", (
            tcfg, TrainConfig(**TC), sd_np, batches, shape == (2, 2)),
            timeout=left())
        for out in outs:
            np.testing.assert_allclose(out["losses"], want, rtol=1e-5,
                                       err_msg=str(shape))
        if shape == (2, 2):
            got = outs[0]["grads"]
            assert set(got) == set(jgrads)
            for n, g in got.items():
                np.testing.assert_allclose(g, jgrads[n].numpy(), rtol=0,
                                           atol=1e-4, err_msg=n)


def test_expert_parallel_prefill_and_a_resume_on_another_mesh(tmp_path):
    """olmoe-1b-7b smoke (f32, 8 experts, top-2, capacity 8.0: no copy is
    dropped) with ``moe_impl="ep"`` on mesh 1x4 (2 experts a rank, heads
    and vocab split 4 ways): the prefill's last logits within 1e-4 and its
    aux within rtol 1e-4 of the reference's prefill through its dense MoE
    path (``tests/test_sharding.py``'s EP check, here on four ranks).
    Then ``launch/train.run`` trains 2 steps on mesh 2x2 with a
    checkpoint; resumed on mesh 1x4 and in one process (1x1), the next
    loss agrees within rtol 1e-6."""
    left = _deadline()
    arch = "olmoe-1b-7b"
    jcfg = jconfigs.get_smoke_config(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_experts=8, capacity_factor=8.0))
    tcfg = tconfigs.get_smoke_config(arch)
    tcfg = dataclasses.replace(tcfg, moe_impl="ep", moe=dataclasses.replace(
        tcfg.moe, num_experts=8, capacity_factor=8.0))
    jparams, sd = _reference_params(jcfg, tcfg)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    out = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                        mode="prefill")
    got = t_train.spawn(t_train.prefill_job, (1, 4), "gloo", "cpu", (
        tcfg, {n: t.numpy() for n, t in sd.items()}, tokens),
        timeout=left())[0]
    np.testing.assert_allclose(got["last_logits"],
                               np.asarray(out["logits"][:, -1]), rtol=0,
                               atol=1e-4)
    assert got["aux"] == pytest.approx(float(out["aux"]), rel=1e-4)
    assert got["aux"] > 0

    ckpt, copy = str(tmp_path / "ckpt"), str(tmp_path / "copy")
    kw = dict(batch=4, seq=8, log_every=1, device="cpu", moe_impl="ep")
    t_train.run(arch, steps=2, ckpt_dir=ckpt, mesh="2x2", timeout=left(),
                **kw)
    shutil.copytree(ckpt, copy)
    _, resumed = t_train.run(arch, steps=3, ckpt_dir=ckpt, mesh="1x4",
                             timeout=left(), **kw)
    _, one = t_train.run(arch, steps=3, ckpt_dir=copy, **kw)
    assert [h["step"] for h in resumed] == [h["step"] for h in one] == [3]
    assert resumed[0]["loss"] == pytest.approx(one[0]["loss"], rel=1e-6)
