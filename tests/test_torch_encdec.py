"""The encoder-decoder family (whisper-small, ``audio``) against the JAX
package's, at smoke size (2 encoder and 2 decoder layers, d_model 64,
vocab 512, Bloom m 128 k 3, f32), with the reference's params carried
over by ``encdec_params_from_jax`` and frames drawn by numpy from a
seed (nonzero: zero frames make the encoder's output exactly 0, so the
cross attention's values would be 0 and a decode that ignored the
encoder would print the same tokens).

Tolerances: ``layer_norm`` within 1e-6; the encoder output, the train
logits, the prefill's self and cross k/v and last logits, and one decode
step within 1e-5 (torch and XLA sum f32 matmuls in another order, and the
reference chunks its attention flash-style); ``encdec_loss_fn`` and every
gradient within 1e-4 of ``jax.value_and_grad``, the reference's own
gradient tolerance; a 4-step trajectory of ``launch/train.run`` within
rtol 1e-5 of the reference's ``run``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import encdec as t_encdec
from repro_torch.models import layers as t_layers
from repro_torch.serving.engine import Engine

ARCH = "whisper-small"
B, S, S_ENC = 2, 7, 12
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
    sd = t_encdec.encdec_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, size=(B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, S_ENC, tcfg.d_model)).astype(
        np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, sd=sd,
                tokens=tokens, frames=frames)


def _model(ref):
    model = t_encdec.EncDec(ref["tcfg"])
    model.load_state_dict(ref["sd"])
    return model


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


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
    assert (full.param_count(), full.m_vocab) == (242_259_456, 10_240)
    # the module has the reference's every param, once (param_count, the
    # reference's analytic count, leaves out the cross attention, the
    # norm_x gains and frontend_proj)
    model = t_encdec.EncDec(ref["tcfg"])
    assert set(model.state_dict()) == set(ref["sd"])
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(ref["jparams"]))


def test_layer_norm_matches_the_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64)) * 4 + 2).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = j_layers.layer_norm({"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = t_layers.layer_norm(torch.from_numpy(scale),
                              torch.from_numpy(bias), torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    # the init (ones, zeros) and a bf16 input, computed in f32
    xb = torch.from_numpy(x).bfloat16()
    got = t_layers.layer_norm(torch.ones(64), torch.zeros(64), xb)
    want = j_layers.layer_norm(j_layers.layer_norm_init(64),
                               jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 1e-6)


def test_cross_attention_matches_the_reference(ref):
    """The whole cross attention (keys and values projected from the
    encoder output) and the decode-time one over k/v projected ahead, on
    the first decoder block's weights."""
    from repro.models import attention as j_attn
    from repro_torch.models import attention as t_attn
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    enc = ref["frames"]
    jp = jax.tree.map(lambda a: a[0], ref["jparams"]["decoder"])["cross_attn"]
    want = j_attn.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(enc),
                                  jnp.broadcast_to(jnp.arange(S), (B, S)))
    p = model.decoder[0].cross_attn
    with torch.no_grad():
        got = t_attn.cross_attention(p, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(enc))
        k, v = t_attn.project_kv(p, tcfg, torch.from_numpy(enc))
        one = t_attn.cross_attention_kv(p, tcfg, torch.from_numpy(x[:, -1:]),
                                        k, v)
    assert float(jnp.abs(want).max()) > 0.1
    _close(got, want, 1e-5, "cross attention")
    _close(one[:, 0], want[:, -1], 1e-5, "one query over cached k/v")


def test_encode_and_train_logits_match_the_reference(ref):
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    frames, tokens = ref["frames"], ref["tokens"]
    want = _jit(lambda p, f: j_encdec.encode(p, jcfg, f), ref["jparams"],
                jnp.asarray(frames))
    with torch.no_grad():
        got = t_encdec.encode(model, tcfg, torch.from_numpy(frames))
        out = t_encdec.encdec_apply(model, tcfg, torch.from_numpy(tokens),
                                    mode="train",
                                    embeds=torch.from_numpy(frames))
    assert got.shape == (B, S_ENC, tcfg.d_model)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, 1e-5, "encoder output")
    jout = _jit(lambda p, t, f: j_encdec.encdec_apply(
        p, jcfg, {"tokens": t, "embeds": f}, mode="train"),
        ref["jparams"], jnp.asarray(tokens), jnp.asarray(frames))
    assert out["logits"].shape == (B, S + 1, tcfg.m_vocab)
    _close(out["logits"], jout["logits"], 1e-5, "train logits")
    assert float(out["aux"]) == 0.0


def test_prefill_and_decode_match_the_reference(ref):
    """Prefill S tokens and the frames, place the caches into an f32 pool
    of S + 1 positions, decode token S: the self and cross k/v and the
    logits equal the reference's, the decode step equals both the
    reference's decode step and a full pass over S + 1 tokens."""
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    tokens, frames = ref["tokens"], ref["frames"]
    jpre = _jit(lambda p, t, f: j_encdec.encdec_apply(
        p, jcfg, {"tokens": t, "embeds": f}, mode="prefill"),
        ref["jparams"], jnp.asarray(tokens[:, :S]), jnp.asarray(frames))
    prefill = t_steps.make_prefill_step(tcfg)
    pre = prefill(model, torch.from_numpy(tokens[:, :S]),
                  torch.from_numpy(frames))
    _close(pre["last_logits"], jpre["logits"][:, -1], 1e-5, "last logits")
    jc = jpre["caches"]
    for i, c in enumerate(pre["caches"]):
        assert set(c) == {"k", "v", "cross_k", "cross_v"}
        assert c["cross_k"].shape == (B, S_ENC, tcfg.num_kv_heads,
                                      tcfg.resolved_head_dim)
        for name, (a, b) in {"k": ("attn", "k"), "v": ("attn", "v"),
                             "cross_k": ("cross", "k"),
                             "cross_v": ("cross", "v")}.items():
            _close(c[name], jc[a][b][i], 1e-5, f"layer {i} {name}")

    pool = t_encdec.init_encdec_cache(tcfg, B, S + 1, S_ENC,
                                      dtype=torch.float32)
    pool = t_steps.insert_cache_slot(pool, pre["caches"], 0)
    jpool = j_steps.insert_cache_slot(
        j_encdec.init_encdec_cache(jcfg, B, S + 1, S_ENC, jnp.float32),
        jc, 0)
    tok = tokens[:, S:]
    with torch.inference_mode():
        dec = t_encdec.encdec_apply(
            model, tcfg, torch.from_numpy(tok), mode="decode", caches=pool,
            pos=torch.full((B,), S))
        full = t_encdec.encdec_apply(model, tcfg, torch.from_numpy(tokens),
                                     mode="train",
                                     embeds=torch.from_numpy(frames))
    jdec = _jit(lambda p, t, c: j_encdec.encdec_apply(
        p, jcfg, {"tokens": t}, mode="decode", caches=c, pos=jnp.int32(S)),
        ref["jparams"], jnp.asarray(tok), jpool)
    assert dec["logits"].shape == (B, 1, tcfg.m_vocab)
    _close(dec["logits"], jdec["logits"], 1e-5, "decode vs reference")
    _close(dec["logits"][:, 0], full["logits"][:, -1], 1e-5,
           "decode vs full pass")
    for i, c in enumerate(dec["caches"]):
        _close(c["k"], jdec["caches"]["attn"]["k"][i], 1e-5, f"k {i}")
        # decode reads the cross k/v and leaves them as prefill wrote them
        assert torch.equal(c["cross_v"], pre["caches"][i]["cross_v"])


def test_zero_frames_give_an_encoder_output_of_exactly_zero(ref):
    """Both packages: frontend_proj(0) = 0, and RMSNorm, RoPE, attention
    and SwiGLU of 0 are 0 (the reference's serve and train entry points feed
    zero frames)."""
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    zeros = np.zeros((B, S_ENC, tcfg.d_model), np.float32)
    want = _jit(lambda p, f: j_encdec.encode(p, jcfg, f), ref["jparams"],
                jnp.asarray(zeros))
    with torch.no_grad():
        got = t_encdec.encode(model, tcfg, torch.from_numpy(zeros))
    assert float(jnp.abs(want).max()) == 0.0
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradients_match_jax_grad(ref, masked):
    """``encdec_loss_fn`` is the mean over every predicted position, the
    masked ones counted as 0 (not ``lm_loss_fn``'s mean over the mask)."""
    jcfg, tcfg, model = ref["jcfg"], ref["tcfg"], _model(ref)
    tokens, frames = ref["tokens"], ref["frames"]
    batch = {"tokens": tokens, "embeds": frames}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((B, S))
                              < 0.6).astype(np.float32)
    (jloss, _), jgrads = _jit(jax.value_and_grad(
        lambda p, b: j_encdec.encdec_loss_fn(p, jcfg, b), has_aux=True),
        ref["jparams"], jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = t_steps.value_and_grad(model, tcfg, tbatch)
    assert t_steps.loss_fn_for(tcfg)(model, tbatch)[0].item() == \
        pytest.approx(loss.item(), abs=0)
    _close(loss, jloss, 1e-4, "loss")
    assert set(metrics) == {"ce", "aux"} and float(metrics["aux"]) == 0.0
    if masked:
        out = t_encdec.encdec_apply(model, tcfg, tbatch["tokens"],
                                    mode="train", embeds=tbatch["embeds"])
        per = t_encdec.io.lm_loss(tcfg, out["logits"][:, :-1],
                                  tbatch["tokens"][:, 1:])
        want = (per * tbatch["loss_mask"]).sum() / per.numel()
        assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    want = t_encdec.encdec_params_from_jax(
        jax.tree.map(np.asarray, jgrads), tcfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name], 1e-4, name)
    assert float(grads["frontend_proj"].abs().max()) > 0


def test_trajectory_matches_the_reference_run(ref, monkeypatch):
    """4 steps of launch/train.run (batch 4, seq 16, the reference's zero
    frames) from the reference's params on the same data."""
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


def test_steps_dispatch_and_the_cache_pool(ref):
    """The step builders' audio branch, the serving cast and the cache
    insert: cross k/v (no growing sequence axis) replaced whole."""
    tcfg = ref["tcfg"]
    assert t_steps.apply_fn_for(tcfg) is t_encdec.encdec_apply
    assert t_steps.model_class_for(tcfg) is t_encdec.EncDec
    assert isinstance(t_steps.init_fn_for(tcfg)(0), t_encdec.EncDec)
    caches = t_steps.init_caches_for(tcfg, ShapeConfig("c", 16, 3,
                                                       "decode"))()
    assert len(caches) == tcfg.num_layers
    assert caches[0]["k"].shape == (3, 16, 4, 16)
    assert caches[0]["cross_k"].shape == (3, 1500, 4, 16)
    assert caches[0]["k"].dtype == torch.bfloat16
    # the serving cast: the blocks and the 2-D params, not the two norms
    bf = t_steps.cast_params_for_compute(
        _model(ref), dataclasses.replace(tcfg, dtype="bfloat16"))
    dtypes = {n: p.dtype for n, p in bf.named_parameters()}
    assert dtypes.pop("enc_norm") == dtypes.pop("final_norm") == \
        torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    # insert a 2-row prefill into rows 1-2 of a 4-slot pool of noise
    g = torch.Generator().manual_seed(0)
    pool = [{n: torch.randn(4, 16 if n in ("k", "v") else S_ENC, 4, 16,
                            generator=g) for n in c} for c in caches[:1]]
    before = [{n: t.clone() for n, t in c.items()} for c in pool]
    small = [{n: torch.randn(2, 9 if n in ("k", "v") else S_ENC, 4, 16,
                             generator=g) for n in c} for c in pool]
    t_steps.insert_cache_slot(pool, small, 1)
    for c, b, s in zip(pool, before, small):
        for n in ("k", "v"):
            assert torch.equal(c[n][1:3, :9], s[n])
            assert torch.equal(c[n][1:3, 9:], b[n][1:3, 9:])
        for n in ("cross_k", "cross_v"):
            assert torch.equal(c[n][1:3], s[n])
        for n in c:
            assert torch.equal(c[n][0], b[n][0])
            assert torch.equal(c[n][3], b[n][3])


def test_serve_cli_static_and_the_engine_refusal(capsys):
    t_serve.main(["--arch", ARCH, "--device", "cpu", "--static", "--batch",
                  "2", "--prompt-len", "8", "--gen", "4", "--topk", "4"])
    out = capsys.readouterr().out
    assert "whole-batch serving (whisper-small 2L d_model 64" in out
    assert "4 zero audio_stub embeddings" in out
    assert "prefill 8 toks x2:" in out and "decode  3 steps:" in out
    assert "generated ids (first seq):" in out
    with pytest.raises(SystemExit, match="--static"):
        t_serve.main(["--arch", ARCH, "--device", "cpu"])
    cfg = tconfigs.get_smoke_config(ARCH)
    assert not Engine.supports(cfg)
    assert Engine.supports(tconfigs.get_smoke_config("qwen3-4b"))
    with pytest.raises(NotImplementedError, match="static"):
        Engine(cfg, t_encdec.EncDec(cfg), n_slots=2, max_len=8)
