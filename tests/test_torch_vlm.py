"""The vision-frontend family (pixtral-12b, ``vlm``) against the JAX
package's, at smoke size (2 layers, d_model 64, GQA 4/2, vocab 512,
Bloom m 128 k 3, f32), with the reference's params carried over by
``lm_params_from_jax`` (``frontend_proj`` among them) and image
embeddings drawn by numpy from a seed.

Tolerances: logits and KV caches with the frontend's prefix within 1e-5
(torch and XLA sum f32 matmuls in another order); ``lm_loss_fn`` over
the text region and every gradient within 1e-4 of ``jax.value_and_grad``;
the first decode step behind the prefix, from an f32 cache, within 1e-5
of a full pass and of the reference's decode step at that position;
``serve.generate``'s own first step, from its bf16 cache, within 2^-5 x
max |full pass| (the cache's rounding).  The reference's ``run`` decodes
at ``prompt_len`` instead, which overwrites a prompt token's k/v; the
test shows that this position misses the full pass."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf
from repro_torch.serving.engine import Engine

ARCH = "pixtral-12b"
B, S, S_EMB = 2, 8, 4
FIELDS = ("name", "family", "num_layers", "encoder_layers", "d_model",
          "num_heads", "num_kv_heads", "d_ff", "vocab", "head_dim",
          "resolved_head_dim", "m_vocab", "qk_norm", "qkv_bias",
          "rope_theta", "use_rope", "norm_eps", "tie_embeddings", "dtype",
          "frontend", "frontend_frac", "table_dtype", "bwd_impl")


def _jit(fn, *args):
    """fn(*args) for the reference, jitted at XLA's lowest backend
    optimisation level (one-off programs compile faster)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(scope="module")
def ref():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0))
    sd = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, size=(B, S + 1)).astype(np.int32)
    embeds = rng.standard_normal((B, S_EMB, tcfg.d_model)).astype(
        np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, sd=sd,
                tokens=tokens, embeds=embeds)


def _model(ref):
    model = t_tf.TransformerLM(ref["tcfg"])
    model.load_state_dict(ref["sd"])
    return model.eval()


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _full_last(model, cfg, tokens, embeds):
    """The last position's logits of a train-mode pass over the prefix and
    ``tokens``."""
    with torch.inference_mode():
        return t_tf.lm_apply(model, cfg, torch.from_numpy(tokens),
                             mode="train",
                             embeds=torch.from_numpy(embeds))["logits"][:, -1]


def test_config_matches_the_reference(ref):
    for full in (False, True):
        j = jconfigs.get_config(ARCH) if full else \
            jconfigs.get_smoke_config(ARCH)
        t = tconfigs.get_config(ARCH) if full else \
            tconfigs.get_smoke_config(ARCH)
        for f in FIELDS:
            assert getattr(t, f) == getattr(j, f), f
        assert dataclasses.asdict(t.bloom) == dataclasses.asdict(j.bloom)
        assert t.param_count() == j.param_count()
    full = tconfigs.get_config(ARCH)
    assert (full.param_count(), full.m_vocab) == (11_172_992_000, 26_112)
    assert full.m_vocab <= 57_344       # the decode kernels' MAX_M
    # the module has the reference's every param (param_count, the
    # reference's analytic count, leaves out frontend_proj)
    model = t_tf.TransformerLM(ref["tcfg"])
    assert set(model.state_dict()) == set(ref["sd"])
    assert model.frontend_proj.shape == (64, 64)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(ref["jparams"]))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_lm_apply_with_embeddings_matches_the_reference(ref, mode):
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    tokens, embeds = ref["tokens"][:, :S], ref["embeds"]
    jout = _jit(lambda p, t, e: j_tf.lm_apply(
        p, jcfg, {"tokens": t, "embeds": e}, mode=mode),
        ref["jparams"], jnp.asarray(tokens), jnp.asarray(embeds))
    with torch.inference_mode():
        out = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens), mode=mode,
                            embeds=torch.from_numpy(embeds))
    assert out["logits"].shape == (B, S_EMB + S, tcfg.m_vocab)
    _close(out["logits"], jout["logits"], 1e-5, "logits")
    if mode == "prefill":
        for i, c in enumerate(out["caches"]):
            assert c["k"].shape == (B, S_EMB + S, 2, 16)
            for n in ("k", "v"):
                _close(c[n], jout["caches"][f"sub{0}"]["attn"][n][i], 1e-5,
                       f"layer {i} {n}")


def test_frontend_prefix_changes_logits(ref):
    """The port of tests/test_models_transformer.py's
    ``test_vlm_frontend_prefix_changes_logits``: two prefixes, the same
    tokens, other logits (at the text positions too)."""
    tcfg, model = ref["tcfg"], _model(ref)
    tokens = torch.from_numpy(ref["tokens"][:1, :6])
    rng = np.random.default_rng(5)
    e1, e2 = (torch.from_numpy(rng.standard_normal(
        (1, 4, tcfg.d_model)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        o1 = t_tf.lm_apply(model, tcfg, tokens, "train", embeds=e1)["logits"]
        o2 = t_tf.lm_apply(model, tcfg, tokens, "train", embeds=e2)["logits"]
        o0 = t_tf.lm_apply(model, tcfg, tokens, "train")["logits"]
    assert o1.shape[1] == 10 and o0.shape[1] == 6  # 4 patches + 6 tokens
    assert float((o1 - o2)[:, 4:].abs().max()) > 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_loss_over_the_text_region_and_gradients_match_jax_grad(ref,
                                                                 masked):
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    batch = {"tokens": ref["tokens"], "embeds": ref["embeds"]}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((B, S))
                              < 0.6).astype(np.float32)
    (jloss, jm), jgrads = _jit(jax.value_and_grad(
        lambda p, b: j_tf.lm_loss_fn(p, jcfg, b), has_aux=True),
        ref["jparams"], jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.train()
    loss, metrics, grads = t_steps.value_and_grad(model, tcfg, tbatch)
    _close(loss, jloss, 1e-4, "loss")
    _close(metrics["ce"], jm["ce"], 1e-4, "ce")
    # the text region only: the same loss as the tokens' own logits
    with torch.no_grad():
        logits = t_tf.lm_apply(model, tcfg, tbatch["tokens"], "train",
                               embeds=tbatch["embeds"])["logits"][:, S_EMB:]
        per = t_tf.io.lm_loss(tcfg, logits[:, :-1], tbatch["tokens"][:, 1:],
                              tbatch.get("loss_mask"))
    denom = float(tbatch["loss_mask"].sum()) if masked else per.numel()
    assert loss.item() == pytest.approx(per.sum().item() / denom, rel=1e-6)
    want = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name], 1e-4, name)
    assert float(grads["frontend_proj"].abs().max()) > 0


def test_first_decode_step_is_at_the_prefix_end(ref):
    """Prefill S_EMB embeddings and S tokens, place the caches into an f32
    pool of ``serve.decode_caches``'s shape and decode the next token at
    its first position, S_EMB + S: within 1e-5 of a full pass over
    S_EMB + S + 1 positions and of the reference's decode step called at
    that position.  The reference's ``run`` calls it at ``prompt_len``
    (S): that step overwrites the k/v of a prompt token and masks out the
    last S_EMB - 1, and misses the full pass by far more."""
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    tokens, embeds = ref["tokens"], ref["embeds"]
    template, n_prefix = t_serve.decode_caches(
        tcfg, B, S, 1, torch.from_numpy(embeds), "cpu")
    assert n_prefix == S_EMB + S
    assert template[0]["k"].shape[1] == S_EMB + S + 1
    pre = t_steps.make_prefill_step(tcfg)(
        model, torch.from_numpy(tokens[:, :S]), torch.from_numpy(embeds))
    pool = t_steps.insert_cache_slot(
        [{n: a.float() for n, a in c.items()} for c in template],
        pre["caches"], 0)
    with torch.inference_mode():
        dec = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens[:, S:]),
                            mode="decode", caches=pool,
                            pos=torch.full((B,), n_prefix))["logits"][:, 0]
    full = _full_last(model, tcfg, tokens, embeds)
    _close(dec, full, 1e-5, "decode at S_emb + S vs the full pass")

    jpre = _jit(lambda p, t, e: j_tf.lm_apply(
        p, jcfg, {"tokens": t, "embeds": e}, mode="prefill"),
        ref["jparams"], jnp.asarray(tokens[:, :S]), jnp.asarray(embeds))
    jpool = j_steps.insert_cache_slot(
        j_tf.init_lm_cache(jcfg, B, n_prefix + 1, jnp.float32),
        jpre["caches"], 0)

    def jdecode(pos):
        return _jit(lambda p, t, c: j_tf.lm_apply(
            p, jcfg, {"tokens": t}, mode="decode", caches=c,
            pos=jnp.int32(pos)), ref["jparams"],
            jnp.asarray(tokens[:, S:]), jpool)["logits"][:, 0]

    _close(dec, jdecode(n_prefix), 1e-5, "the reference's step there")
    # the reference's own position misses the full pass
    assert float(np.abs(np.asarray(jdecode(S)) - full.numpy()).max()) > 0.1


def test_generate_first_step_equals_a_full_pass(ref, monkeypatch):
    """``serve.generate`` with the prefix: its first decode step (bf16
    cache, as served) equals a full pass over the prompt, the prefix and
    the token it recovered, within the cache's rounding."""
    tcfg, model = ref["tcfg"], _model(ref)
    tokens, embeds = ref["tokens"][:, :S], ref["embeds"]
    seen = []
    make = t_steps.make_decode_step

    def recording(cfg, topk, device):
        step = make(cfg, topk, device)

        def run(model, token, caches, pos):
            out = step(model, token, caches, pos)
            seen.append((token.clone(), pos, out["logits"][:, 0].clone()))
            return out
        return run

    monkeypatch.setattr(t_serve.steps_lib, "make_decode_step", recording)
    ids, _, _ = t_serve.generate(tcfg, model, tokens, 3, 4,
                                 torch.from_numpy(embeds))
    assert ids.shape == (B, 3)
    assert [p for _, p, _ in seen] == [S_EMB + S, S_EMB + S + 1]
    first, _, logits = seen[0]
    assert np.array_equal(first.numpy()[:, 0], ids[:, 0])
    full = _full_last(model, tcfg,
                      np.concatenate([tokens, ids[:, :1]], 1), embeds)
    tol = 2 ** -5 * float(full.abs().max())
    _close(logits, full, tol, "generate's first step vs the full pass")


def test_serve_cli_and_the_engine_refusal(capsys):
    t_serve.main(["--arch", ARCH, "--device", "cpu", "--static", "--batch",
                  "2", "--prompt-len", "8", "--gen", "4", "--topk", "4"])
    out = capsys.readouterr().out
    assert "whole-batch serving (pixtral-12b 2L d_model 64" in out
    assert "4 zero vision_stub embeddings" in out
    assert "prefill 8 toks x2:" in out and "decode  3 steps:" in out
    assert "generated ids (first seq):" in out
    with pytest.raises(SystemExit, match="--static"):
        t_serve.main(["--arch", ARCH, "--device", "cpu"])
    cfg = tconfigs.get_smoke_config(ARCH)
    assert not Engine.supports(cfg)
    with pytest.raises(NotImplementedError, match="static"):
        Engine(cfg, t_tf.TransformerLM(cfg), n_slots=2, max_len=8)
