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

import torch

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as j_steps
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoEConfig, ModelConfig, TrainConfig
from repro_torch.launch import collectives
from repro_torch.launch import sharding
from repro_torch.launch import train as t_train
from repro_torch.models import moe as t_moe
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
    shapes = ((2, 2), (1, 4))
    # both meshes in one world of four ranks (one start)
    per_rank = t_train.spawn(t_train.run_jobs, (2, 2), "gloo", "cpu", ([
        (shape, t_train.train_job, (tcfg, TrainConfig(**TC), sd_np, batches,
                                    shape == (2, 2))) for shape in shapes],),
        timeout=left())
    for i, shape in enumerate(shapes):
        outs = [r[i] for r in per_rank]
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


# tests/test_torch_moe.py's 8-expert top-2 layer (d_model 16, f32)
MOE_KW = dict(name="moe", family="moe", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=2, d_ff=32, vocab=64,
              dtype="float32")


def _moe_cfgs(cf):
    mkw = dict(num_experts=8, top_k=2, num_shared=0, d_ff_expert=24,
               capacity_factor=cf)
    return (JModelConfig(moe=JMoEConfig(**mkw), **MOE_KW),
            ModelConfig(moe=MoEConfig(**mkw), **MOE_KW))


def dense_moe_job(mesh, cases):
    """One rank of the dense MoE layer on a mesh of D x 1: for each
    (cfg, params, x (B, S, D) global, w (B, S, D)) this rank's rows
    (``sharding.local_batch``) through ``moe.moe_apply`` and ``route``,
    and the router's gradient of D·Σ out·w + aux averaged over the data
    axis (``collectives.data_mean``, as the train step averages).
    Returns per case {"out", "aux", "pos", "keep", "grad"}, numpy."""
    dist = sharding.DistContext(mesh)
    results = []
    for cfg, params, x, w in cases:
        model = t_moe.MoE(cfg)
        model.load_state_dict({n: torch.as_tensor(v)
                               for n, v in params.items()})
        rows = sharding.local_batch({"x": torch.as_tensor(x),
                                     "w": torch.as_tensor(w)}, dist)
        out, aux = t_moe.moe_apply(model, rows["x"], cfg, dist)
        (dist.n_batch * (out * rows["w"]).sum() + aux).backward()
        grad = collectives.data_mean({"router": model.router.grad}, dist)
        flat = rows["x"].reshape(-1, cfg.d_model)
        with torch.no_grad():
            r = t_moe.route(model.router, flat, cfg, dist=dist)
            # every rank holding the whole batch (a replicated prefill)
            whole, whole_aux = t_moe.moe_apply(
                model, torch.as_tensor(x), cfg,
                dataclasses.replace(dist, rows_split=False))
        results.append({"out": out.detach().numpy(),
                        "aux": float(aux.detach()),
                        "pos": r.pos.numpy(), "keep": r.keep.numpy(),
                        "grad": grad["router"].numpy(),
                        "whole": whole.numpy(),
                        "whole_aux": float(whole_aux)})
    return results


def test_dense_moe_on_a_data_axis_routes_the_global_batch():
    """The dense MoE (``moe_impl="dense"``) on two gloo ranks, mesh 2x1,
    each holding half the rows of a (4, 8) batch: its outputs within 1e-5
    and its aux within 1e-6 of the reference's ``moe_apply`` on the
    global batch, the queue positions and kept copies equal to the
    reference's global routing, and the router's gradient of
    Σ out·w + aux, averaged over the ranks, within 1e-5 of ``jax.grad``
    on the global batch; at capacity factor 0.25 (drops that depend on
    the other shard's copies) and 8.0 (none).  A rank holding the whole
    batch (``rows_split=False``, a replicated prefill) routes it alone,
    to the same outputs and aux."""
    left = _deadline()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    w = rng.standard_normal((4, 8, 16)).astype(np.float32)
    cases, wants = [], []
    for cf in (0.25, 8.0):
        jcfg, tcfg = _moe_cfgs(cf)
        jp = j_moe.moe_init(jax.random.PRNGKey(0), jcfg)
        params = {n: np.asarray(v) for n, v in jp.items()}
        cases.append((tcfg, params, x, w))

        def loss(router, jp=jp, jcfg=jcfg):
            out, aux = j_moe.moe_apply({**jp, "router": router},
                                       jnp.asarray(x), jcfg)
            return jnp.sum(out * w) + aux

        out, aux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
        flat = jnp.asarray(x.reshape(-1, 16))
        probs = jax.nn.softmax(flat @ jp["router"], -1)
        sel = np.asarray(jax.lax.top_k(probs, 2)[1]).reshape(-1)
        oh = np.eye(8, dtype=np.int64)[sel]
        pos = ((np.cumsum(oh, 0) - oh) * oh).sum(-1)
        C = j_moe._capacity(32, jcfg)
        wants.append((np.asarray(out), float(aux), pos, pos < C,
                      np.asarray(jax.grad(loss)(jp["router"]))))
    got = t_train.spawn(dense_moe_job, (2, 1), "gloo", "cpu", (cases,),
                        timeout=left())
    for i, (out, aux, pos, keep, grad) in enumerate(wants):
        parts = [g[i] for g in got]
        np.testing.assert_allclose(
            np.concatenate([p["out"] for p in parts]), out, rtol=0,
            atol=1e-5, err_msg=f"case {i}")
        for p in parts:
            assert p["aux"] == pytest.approx(aux, abs=1e-6)
            np.testing.assert_allclose(p["grad"], grad, rtol=0, atol=1e-5)
            np.testing.assert_allclose(p["whole"], out, rtol=0, atol=1e-5)
            assert p["whole_aux"] == pytest.approx(aux, abs=1e-6)
        np.testing.assert_array_equal(
            np.concatenate([p["pos"] for p in parts]), pos)
        np.testing.assert_array_equal(
            np.concatenate([p["keep"] for p in parts]), keep)
    assert not wants[0][3].all() and wants[1][3].all()

