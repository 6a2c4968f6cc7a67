"""Whole-batch serving (``launch/serve.run``, ``generate``,
``pad_caches_to``; ``launch/steps.make_decode_step``, ``init_caches_for``,
``insert_cache_slot``) against the JAX package's, at smoke size (f32),
with the reference's params carried over by ``lm_params_from_jax``.

Tolerances as tests/test_torch_lm.py: logits within 1e-4, KV caches
within 1e-5 (torch and XLA sum f32 matmuls in another order); generated
ids equal, or where a row first differs, a near-tie: the reference's own
Eq. 3 scores of the two ids within 1e-4 (the row's later ids are not
compared)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.core.bloom import decode_scores as j_decode_scores
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import io as j_io
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import common
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf

BATCH, PROMPT, GEN, TOPK = 3, 8, 6, 4


def _port_model(tree, tcfg):
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(tree, tcfg))
    return t_steps.cast_params_for_compute(model, tcfg).eval()


@pytest.fixture(scope="module")
def smoke():
    """qwen3-4b smoke, the reference's params from seed 0 in both."""
    jcfg = jconfigs.get_smoke_config("qwen3-4b")
    tcfg = tconfigs.get_smoke_config("qwen3-4b")
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, _port_model(
        jax.tree.map(np.asarray, jparams), tcfg)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _ref_scores(jparams, jcfg, seq):
    """The reference's Eq. 3 scores of every vocab id after ``seq``."""
    logits = j_tf.lm_apply(jparams, jcfg,
                           {"tokens": jnp.asarray([seq], jnp.int32)},
                           mode="prefill")["logits"][0, -1]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return np.asarray(j_decode_scores(j_io.vocab_spec(jcfg), logp[None]))[0]


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen1.5-0.5b"])
def test_whole_batch_ids_match_the_reference_run(arch, capsys):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams, _ = j_serve._setup(jcfg, 0)
    want = j_serve.run(arch, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                       topk=TOPK, seed=0)
    prompts = np.random.default_rng(0).integers(
        0, tcfg.vocab, size=(BATCH, PROMPT), dtype=np.int32)
    model = _port_model(jax.tree.map(np.asarray, jparams), tcfg)
    common.reset_launches()
    got, t_prefill, t_decode = t_serve.generate(tcfg, model, prompts, GEN,
                                                TOPK)
    assert common.LAUNCHES == {}
    assert got.shape == want.shape == (BATCH, GEN) and got.dtype == np.int32
    assert t_prefill > 0 and t_decode > 0
    for b in range(BATCH):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:
            i = int(diff[0])
            s = _ref_scores(jparams, jcfg,
                            list(prompts[b]) + list(want[b, :i]))
            assert abs(s[got[b, i]] - s[want[b, i]]) <= 1e-4, (b, i)
    capsys.readouterr()


def test_decode_step_at_one_position_matches_the_slot_step(smoke):
    """The whole-batch step broadcasts its scalar ``pos`` to every row:
    the same logits as ``lm_apply`` at that per-row offset, the same ids,
    scores and caches as the slot step with every row live, and logits
    and caches within tolerance of the reference's whole-batch step."""
    jcfg, tcfg, jparams, model = smoke
    tokens = _tokens((2, 7), tcfg.vocab)
    nxt = _tokens((2, 1), tcfg.vocab, seed=1)
    with torch.inference_mode():
        small = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                              mode="prefill")["caches"]

    def pool():
        return t_steps.insert_cache_slot(
            t_tf.init_lm_cache(tcfg, 2, 12, dtype=torch.float32), small, 0)

    whole = t_steps.make_decode_step(tcfg, TOPK, "cpu")(
        model, torch.from_numpy(nxt), pool(), 7)
    rows = torch.full((2,), 7, dtype=torch.long)
    slot = t_steps.make_slot_decode_step(tcfg, TOPK, "cpu")(
        model, torch.from_numpy(nxt), pool(), rows,
        torch.ones(2, dtype=torch.bool))
    with torch.inference_mode():
        direct = t_tf.lm_apply(model, tcfg, torch.from_numpy(nxt),
                               mode="decode", caches=pool(), pos=rows)
    assert torch.equal(whole["logits"], direct["logits"])
    assert torch.equal(whole["topk_ids"], slot["topk_ids"])
    assert torch.equal(whole["topk_scores"], slot["topk_scores"])
    for a, b in zip(whole["caches"], slot["caches"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])

    jsmall = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                           mode="prefill")["caches"]
    jpool = j_serve.pad_caches_to(
        jsmall, j_tf.init_lm_cache(jcfg, 2, 12, dtype=jnp.float32))
    jout = j_steps.make_decode_step(jcfg, topk=TOPK)(
        jparams, jnp.asarray(nxt), jpool, jnp.int32(7))
    np.testing.assert_allclose(whole["logits"].numpy(),
                               np.asarray(jout["logits"]), rtol=0, atol=1e-4)
    for i, kv in enumerate(whole["caches"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                kv[name].numpy(),
                np.asarray(jout["caches"]["sub0"]["attn"][name][i]),
                rtol=0, atol=1e-5)


def test_pad_and_init_caches_match_the_reference(smoke):
    jcfg, tcfg, jparams, model = smoke
    tcache = t_steps.init_caches_for(tcfg, ShapeConfig("c", 12, 2,
                                                       "decode"))()
    jcache = j_steps.init_caches_for(jcfg, JShape("c", 12, 2, "decode"))()
    jkv = jcache["sub0"]["attn"]
    assert len(tcache) == jkv["k"].shape[0] == tcfg.num_layers
    for kv in tcache:
        for name in ("k", "v"):
            assert tuple(kv[name].shape) == jkv[name].shape[1:]
            assert kv[name].dtype == torch.bfloat16 and \
                jkv[name].dtype == jnp.bfloat16
            assert not kv[name].any()

    tokens = _tokens((2, 5), tcfg.vocab, seed=4)
    jsmall = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                           mode="prefill")["caches"]
    jpad = j_serve.pad_caches_to(
        jsmall, j_tf.init_lm_cache(jcfg, 2, 12, dtype=jnp.float32))
    with torch.inference_mode():
        tsmall = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                               mode="prefill")["caches"]
    tpad = t_serve.pad_caches_to(
        tsmall, t_tf.init_lm_cache(tcfg, 2, 12, dtype=torch.float32))
    for i, kv in enumerate(tpad):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                kv[name].numpy(),
                np.asarray(jpad["sub0"]["attn"][name][i]), rtol=0, atol=1e-5)
            assert not kv[name][:, 5:].any()


def test_insert_cache_slot_writes_every_row_of_a_batch(smoke):
    """A 2-row prefill inserted at slot 1 of a 4-slot pool fills rows 1
    and 2, as the reference's ``insert_cache_slot`` does; rows 0 and 3
    and the positions past the prompt stay as they were (zero)."""
    jcfg, tcfg, jparams, model = smoke
    tokens = _tokens((2, 6), tcfg.vocab, seed=5)
    jsmall = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                           mode="prefill")["caches"]
    jpool = j_steps.insert_cache_slot(
        j_tf.init_lm_cache(jcfg, 4, 10, dtype=jnp.float32), jsmall, 1)
    with torch.inference_mode():
        tsmall = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                               mode="prefill")["caches"]
    tpool = t_steps.insert_cache_slot(
        t_tf.init_lm_cache(tcfg, 4, 10, dtype=torch.float32), tsmall, 1)
    for i, kv in enumerate(tpool):
        for name in ("k", "v"):
            want = np.asarray(jpool["sub0"]["attn"][name][i])
            assert want[2, :6].any() and not want[[0, 3]].any()
            np.testing.assert_allclose(kv[name].numpy(), want, rtol=0,
                                       atol=1e-5)
            assert kv[name][2, :6].abs().sum() > 0


def test_loss_and_apply_fns_for_the_dense_family(smoke):
    jcfg, tcfg, jparams, model = smoke
    batch = {"tokens": torch.from_numpy(_tokens((2, 6), tcfg.vocab))}
    loss, metrics = t_steps.loss_fn_for(tcfg)(model, batch)
    want, _ = t_tf.lm_loss_fn(model, tcfg, batch)
    assert torch.equal(loss, want) and set(metrics) == {"ce", "aux"}
    assert t_steps.apply_fn_for(tcfg) is t_tf.lm_apply
    audio = tconfigs.get_smoke_config("qwen3-4b", family="audio")
    for fn in (t_steps.loss_fn_for, t_steps.apply_fn_for):
        with pytest.raises(NotImplementedError, match="A12 item 6"):
            fn(audio)
    with pytest.raises(NotImplementedError, match="A12 item 6"):
        t_steps.init_caches_for(audio, ShapeConfig("c", 8, 1, "decode"))


def test_static_cli_serves_the_whole_batch_on_cpu_with_no_kernel(capsys):
    common.reset_launches()
    t_serve.main(["--arch", "qwen3-4b", "--device", "cpu", "--static",
                  "--batch", "2", "--prompt-len", "8", "--gen", "5",
                  "--topk", "4"])
    out = capsys.readouterr().out
    assert common.LAUNCHES == {}
    assert "whole-batch serving (qwen3-4b 2L d_model 64" in out
    assert "prefill 8 toks x2:" in out and "decode  4 steps:" in out
    line = [ln for ln in out.splitlines()
            if ln.startswith("generated ids (first seq):")]
    ids = eval(line[0].split(":", 1)[1])
    assert len(ids) == 5 and all(0 <= i < 512 for i in ids)
    ids_again = t_serve.run("qwen3-4b", batch=2, prompt_len=8, gen=5,
                            topk=4, device="cpu")
    assert ids_again[0].tolist() == ids
