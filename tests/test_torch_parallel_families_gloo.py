"""Tensor parallelism for the ssm, hybrid, audio and vlm families over real
ranks: CPU processes over gloo, started by ``launch/train.spawn``, each
holding its shards of the weights, against the JAX package's
single-device steps on the same weights and data (smoke configs, f32).

* Training (``train.train_job``): mamba2-1.3b on 1x2 and 2x2 (its 8 SSD
  heads split, B and C replicated), whisper-small on 1x2 (heads and
  d_ff split, in the encoder and the cross attention too) and on 1x3
  (none of its dims divides 3: every layer whole on every rank) and
  jamba-v0.1-52b (cut to a Mamba layer and an attention-and-MoE layer)
  on 1x2 with ``moe_impl="ep"``: two steps' losses
  within rtol 1e-5 of the reference's ``make_train_step`` and the first
  step's gathered gradients, B and C's among them, within 1e-4 of
  ``jax.grad``.
* Decode (``serve.decode_job``: prefill, then ``make_decode_step``
  against each rank's cache shards): mamba2 on 1x2 and 1x4,
  jamba-v0.1-52b on 1x2 with ``moe_impl="ep"`` (Mamba mixers, attention
  with its kv heads split, experts split), whisper-small on 1x2 (heads
  split) and on 1x3 (4 heads on 3: the self and cross caches split
  their sequence over ``model``, the softmax partials merged),
  pixtral-12b with B = 1 on 2x1 (the batch does not divide ``data``:
  the cache's sequence splits over it), deepseek-moe-16b (dense MoE, a
  capacity that drops) with B = 3 on 2x1 (the replicated rows routed as
  the whole batch, not as each rank's shard).  Tokens and
  top-k ids equal the reference's, scores and logits within 1e-4, under
  ``tests/test_torch_decode_parallel.py``'s rule for near ties (ids
  whose reference scores tie within 2e-5 may swap, the last of the top
  k with the reference's next-ranked id too; a row whose greedy token
  falls on a tie is compared no further).

Tolerances: the ranks sum the row-parallel products, the gated norm's
squares, the vocab-parallel embedding and the softmax slices in another
order than one device does, so nothing is held bit for bit.

The JAX package's runs are made once, in a module fixture, ahead of the
tests; each test then bounds its ranks' runs (``spawn``'s ``timeout``,
the time left of 85 s from the test's start)."""
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import encdec as j_encdec
from repro.models import io as j_io
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf

TC = dict(optimizer="adamw", learning_rate=3e-3, grad_clip_norm=1.0,
          warmup_steps=0, weight_decay=0.1)
GEN, TOPK = 5, 4


def _deadline():
    """Seconds left, from each call, of the test's 85 s."""
    end = time.monotonic() + 85.0
    return lambda: max(end - time.monotonic(), 1.0)


def family_jobs(mesh, jobs):
    """One rank of each job, on a (data, model) mesh of the job's shape
    over this world: ("train", shape, cfg, params, batches) runs
    ``train.train_job`` with the first step's gradients; ("decode",
    shape, cfg, params, prompts, embeds) runs ``serve.decode_job`` with
    f32 caches.  Returns this rank's results."""
    out = []
    for kind, shape, *args in jobs:
        m = (mesh if tuple(shape) == mesh.sizes else mesh_lib.world_mesh(
            shape, ("data", "model"), mesh.device, mesh.transport))
        if kind == "train":
            cfg, params, batches = args
            out.append(t_train.train_job(m, cfg, TrainConfig(**TC), params,
                                         batches, first_grads=True))
        else:
            cfg, params, prompts, embeds = args
            out.append(t_serve.decode_job(m, cfg, params, prompts, GEN,
                                          TOPK, torch.float32, embeds))
    return out


def _case(arch, seed, **over):
    """(reference config, its params, port config, port params);
    ``capacity_factor`` overrides the MoE's."""
    moe_impl = over.pop("moe_impl", None)
    cf = over.pop("capacity_factor", None)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    if moe_impl is not None:
        tcfg = dataclasses.replace(tcfg, moe_impl=moe_impl)
    jparams = jax.jit(j_steps.init_fn_for(jcfg))(jax.random.PRNGKey(seed))
    params = t_tf.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  t_steps.model_class_for(tcfg))
    return jcfg, jparams, tcfg, {n: t.numpy() for n, t in params.items()}


def _frames(cfg, B, n, seed):
    return (np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _train_case(arch, seed, B=4, S=9, frames=0, **over):
    """A train job's reference: (port job args, reference losses over two
    steps, reference gradients of the first, as port names)."""
    jcfg, jparams, tcfg, params = _case(arch, seed, **over)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(2):
        b = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
        if frames:
            b["embeds"] = _frames(jcfg, B, frames, seed + len(batches))
        batches.append(b)
    jstep, jopt = j_steps.make_train_step(jcfg, JTrainConfig(**TC))
    loss_fn = j_steps.loss_fn_for(jcfg)

    def jloss(p):
        return loss_fn(j_steps.cast_params_for_compute(p, jcfg),
                       {k: jnp.asarray(v) for k, v in batches[0].items()}
                       )[0]

    grads = t_tf.params_from_jax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jparams)), tcfg,
        t_steps.model_class_for(tcfg))
    p, state, losses = jparams, jopt.init(jparams), []
    jstep = jax.jit(jstep)
    for b in batches:
        p, state, m = jstep(p, state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        losses.append(float(m["loss"]))
    return (tcfg, params, batches), losses, grads


def _reference_decode(jcfg, jparams, prompts, embeds):
    """The reference's single-device whole-batch generation at the
    port's positions (the prompt after a ``vlm`` prefix's S_emb
    positions): (ids (B, GEN), the top-k scores (B, TOPK) of each token's
    choice, per decode step outputs, TOPK + 1 wide: the next-ranked id
    shows a tie at the last place)."""
    B, S = prompts.shape
    batch = {"tokens": jnp.asarray(prompts)}
    if embeds is not None:
        batch["embeds"] = jnp.asarray(embeds)
    pre = jax.jit(j_steps.make_prefill_step(jcfg))(jparams, batch)
    if jcfg.family == "audio":
        n = S
        template = j_encdec.init_encdec_cache(jcfg, B, S + GEN,
                                              embeds.shape[1], jnp.float32)
    else:
        n = S + (0 if embeds is None else embeds.shape[1])
        template = j_tf.init_lm_cache(jcfg, B, n + GEN, dtype=jnp.float32)
    caches = j_serve.pad_caches_to(pre["caches"], template)
    decode = jax.jit(j_steps.make_decode_step(jcfg, topk=TOPK + 1))
    scores, ids = j_io.recover_topk(jcfg, pre["last_logits"], topk=TOPK + 1)
    token = ids[:, :1].astype(jnp.int32)
    generated, chosen, steps = [np.asarray(token)], [np.asarray(scores)], []
    for t in range(GEN - 1):
        out = decode(jparams, token, caches, jnp.int32(n + t))
        caches = out["caches"]
        token = out["topk_ids"][:, :1].astype(jnp.int32)
        generated.append(np.asarray(token))
        chosen.append(np.asarray(out["topk_scores"]))
        steps.append({k: np.asarray(out[k]) for k in
                      ("logits", "topk_ids", "topk_scores")})
    return np.concatenate(generated, 1), chosen, steps


@functools.lru_cache(maxsize=None)
def _decode_case(arch, seed, B=4, S=6, frames=0, **over):
    """A decode job's port args and the reference's generation."""
    jcfg, jparams, tcfg, params = _case(arch, seed, **over)
    prompts = np.random.default_rng(seed).integers(
        0, jcfg.vocab, size=(B, S)).astype(np.int32)
    embeds = _frames(jcfg, B, frames, seed) if frames else None
    return ((tcfg, params, prompts, embeds),
            _reference_decode(jcfg, jparams, prompts, embeds))


def _held_train(label, got, want_losses, want_grads):
    for r in got:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5,
                                   err_msg=label)
    grads = got[0]["grads"]
    assert set(grads) == set(want_grads), label
    for n, g in grads.items():
        np.testing.assert_allclose(g, want_grads[n].numpy(), rtol=0,
                                   atol=1e-4, err_msg=f"{label} {n}")


def _same_ids(got, want, want_scores, label):
    """Top-k ids (B, TOPK) equal, but where the reference's score at a
    position ties with a neighbour's (``want_scores`` (B, TOPK + 1))
    within 2e-5."""
    for b, j in zip(*np.nonzero(got != want)):
        s = want_scores[b]
        near = [abs(s[j] - s[i]) for i in (j - 1, j + 1) if 0 <= i < len(s)]
        assert min(near) <= 2e-5, (label, b, j)


def _held_decode(label, g, want):
    ids, chosen, steps = want
    live = np.ones(ids.shape[0], bool)
    for t in range(GEN):
        for b in np.flatnonzero(live & (g["ids"][:, t] != ids[:, t])):
            assert chosen[t][b, 0] - chosen[t][b, 1] <= 2e-5, (label, t, b)
            live[b] = False
        if t == GEN - 1:
            break
        s = steps[t]
        np.testing.assert_allclose(g["logits"][t][live], s["logits"][live],
                                   rtol=0, atol=1e-4,
                                   err_msg=f"{label} logits {t}")
        np.testing.assert_allclose(g["topk_scores"][t][live],
                                   s["topk_scores"][live, :TOPK], rtol=0,
                                   atol=1e-4, err_msg=f"{label} scores {t}")
        _same_ids(g["topk_ids"][t][live], s["topk_ids"][live, :TOPK],
                  s["topk_scores"][live], f"{label} step {t}")
    assert live.sum() >= max(ids.shape[0] - 1, 1), label


def _run(world, trains, decodes, left):
    jobs = ([("train", shape, *args) for shape, args, _, _ in trains]
            + [("decode", shape, *args) for shape, args, _ in decodes])
    out = t_train.spawn(family_jobs, (1, world), "gloo", "cpu", (jobs,),
                        timeout=left())
    for i, (shape, args, losses, grads) in enumerate(trains):
        _held_train(f"{args[0].name} train on {shape}", [r[i] for r in out],
                    losses, grads)
    for j, (shape, args, want) in enumerate(decodes):
        _held_decode(f"{args[0].name} decode on {shape}",
                     out[0][len(trains) + j], want)


# jamba cut to one period of two layers (a Mamba mixer and a dense FFN,
# then attention and the MoE FFN): its train reference compiles in a
# third of the time of the smoke config's eight
JAMBA_2 = {"moe_impl": "ep", "num_layers": 2, "attn_layer_period": 2,
           "attn_layer_offset": 1}
CASES = [("train", "mamba2-1.3b", 0, {}),
         ("decode", "mamba2-1.3b", 2, {}),
         ("decode", "jamba-v0.1-52b", 3, {"moe_impl": "ep"}),
         ("decode", "whisper-small", 4, {"frames": 6}),
         ("decode", "pixtral-12b", 5, {"B": 1, "S": 7, "frames": 4}),
         ("train", "whisper-small", 6, {"frames": 6}),
         ("decode", "whisper-small", 7, {"S": 7, "frames": 6}),
         ("decode", "mamba2-1.3b", 9, {}),
         ("train", "whisper-small", 10, {"frames": 6}),
         ("train", "jamba-v0.1-52b", 11, JAMBA_2),
         ("decode", "deepseek-moe-16b", 12, {"B": 3,
                                             "capacity_factor": 2.0})]


@pytest.fixture(scope="module")
def references():
    """Every case's JAX run, made once for the module (cached by
    ``_train_case`` / ``_decode_case``), so that no test's bound counts
    them."""
    for kind, arch, seed, kw in CASES:
        (_train_case if kind == "train" else _decode_case)(arch, seed, **kw)


def test_two_ranks_mamba_jamba_whisper_and_a_batch_of_one(references):
    """One world of two ranks: mamba2, whisper-small (4 heads and d_ff
    128 split: the encoder's attention and FFN, the cross k/v and the
    cross attention) and jamba (ep, one period of a Mamba and an
    attention layer) train on 1x2; mamba2, jamba and
    whisper-small decode on 1x2 (heads split), pixtral-12b decodes B = 1
    on 2x1 (the cache's sequence split over ``data``), and
    deepseek-moe-16b (dense MoE, k·cf/E = 0.75, so an expert that all
    three rows choose fills its capacity) decodes B = 3 on 2x1: the rows,
    replicated, are routed as the whole batch on each rank."""
    left = _deadline()
    _run(2, [((1, 2), *_train_case("mamba2-1.3b", 0)),
             ((1, 2), *_train_case("whisper-small", 10, frames=6)),
             ((1, 2), *_train_case("jamba-v0.1-52b", 11, **JAMBA_2))],
         [((1, 2), *_decode_case("mamba2-1.3b", 2)),
          ((1, 2), *_decode_case("jamba-v0.1-52b", 3, moe_impl="ep")),
          ((1, 2), *_decode_case("whisper-small", 4, frames=6)),
          ((2, 1), *_decode_case("pixtral-12b", 5, B=1, S=7, frames=4)),
          ((2, 1), *_decode_case("deepseek-moe-16b", 12, B=3,
                                 capacity_factor=2.0))],
         left)


def test_three_ranks_whisper_splits_its_caches_sequence_over_model(
        references):
    """whisper-small (4 heads, 4 kv heads, d_ff 128, m 128: none divides
    3) on 1x3: two training steps with every layer whole on every rank,
    and a decode whose self cache (7 + 5 positions) and cross cache (6
    frames) split their sequence over ``model``."""
    left = _deadline()
    args, losses, grads = _train_case("whisper-small", 6, frames=6)
    _run(3, [((1, 3), args, losses, grads)],
         [((1, 3), *_decode_case("whisper-small", 7, S=7, frames=6))], left)


def test_four_ranks_mamba_on_2x2_and_1x4(references):
    """mamba2 trains on 2x2 (rows and heads split; the two-rank test's
    weights and batches) and decodes on 1x4 (2 SSD heads a rank)."""
    left = _deadline()
    args, losses, grads = _train_case("mamba2-1.3b", 0)
    _run(4, [((2, 2), args, losses, grads)],
         [((1, 4), *_decode_case("mamba2-1.3b", 9))], left)
