"""The MoE, SSM and hybrid archs (deepseek-moe-16b, olmoe-1b-7b,
mamba2-1.3b, jamba-v0.1-52b) against the JAX package's, at smoke size
(f32), with the reference's params carried over by ``lm_params_from_jax``
from its super-block stacks (``sub{j}``, a leading (n_super, ...) axis).

Checked: every config field and the layer-role layout (``period_of``,
``sublayer_roles``, ``num_superblocks``) against the reference's, and
``param_count`` (full and smoke); prefill and one-step decode logits
within 1e-4 and every layer's cache (attention KV, Mamba conv history and
SSM state) within 1e-5, the MoE aux within 1e-5, also with drops
(deepseek at capacity factor 1.0); ``lm_loss_fn`` (ce + aux) and every
gradient within 1e-4 of ``jax.value_and_grad``; the Engine's ids, and its
schedule, equal to the reference Engine's (continuous and static) on the
deepseek and mamba2 smoke configs; ``serve.build_model``, which casts
block by block as it draws, bit-identical to a whole f32 model cast
afterwards; ``insert_cache_slot`` on a 2-row batch, KV leaves at their
positions and Mamba leaves replaced whole, equal to the reference's; and
the serving CLI on these archs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro.serving import Engine as JEngine
from repro.serving import mixed_length_workload as j_workload
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.loadgen import mixed_length_workload as t_workload

ARCHS = ("deepseek-moe-16b", "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b")
FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
          "num_kv_heads", "d_ff", "vocab", "head_dim", "resolved_head_dim",
          "m_vocab", "qk_norm", "qkv_bias", "rope_theta", "use_rope",
          "norm_eps", "tie_embeddings", "dtype", "table_dtype", "bwd_impl",
          "moe_layer_period", "attn_layer_period", "attn_layer_offset",
          "is_attention_free")
# the reference's param_count of each full config
PARAMS = {"deepseek-moe-16b": 16_544_024_576, "olmoe-1b-7b": 6_753_945_600,
          "mamba2-1.3b": 1_281_548_288, "jamba-v0.1-52b": 51_029_850_624}
N_SLOTS, N_REQ, TOPK, MAX_LEN = 3, 10, 4, 40


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, seed: int = 3, cf=None):
    """(jcfg, tcfg, reference params, the port's model on them); made once
    per arguments (no test changes the params)."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    if cf is not None:
        jcfg, tcfg = _with_cf(jcfg, cf), _with_cf(tcfg, cf)
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(seed))
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg))
    return jcfg, tcfg, jparams, model.eval()


def _run_jitted(fn, *args):
    """fn(*args) for the reference, jitted at XLA's lowest backend
    optimisation level: these one-off programs compile 2-3x faster."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _ref_prefill(arch: str, cf=None):
    """The reference's prefill of the (2, 9) test tokens (made once)."""
    jcfg, tcfg, jparams, _ = _pair(arch, cf=cf)
    tokens = _tokens((2, 9), tcfg.vocab)
    return tokens, _run_jitted(lambda p, t: j_tf.lm_apply(
        p, jcfg, {"tokens": t}, mode="prefill"), jparams, jnp.asarray(tokens))


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _ref_cache(jcaches, cfg, i):
    """Layer i's cache leaves in the reference's stacked tree."""
    p = t_tf.period_of(cfg)
    sub = jcaches[f"sub{i % p}"]
    leaves = sub["attn"] if "attn" in sub else sub["mamba"]
    return {n: np.asarray(a[i // p]) for n, a in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_roles_match_the_reference(arch):
    for full in (False, True):
        j = jconfigs.get_config(arch) if full else \
            jconfigs.get_smoke_config(arch)
        t = tconfigs.get_config(arch) if full else \
            tconfigs.get_smoke_config(arch)
        for f in FIELDS:
            assert getattr(t, f) == getattr(j, f), f
        for f in ("bloom", "moe", "mamba"):
            a, b = getattr(t, f), getattr(j, f)
            assert (a is None and b is None) or \
                dataclasses.asdict(a) == dataclasses.asdict(b), f
        assert t.param_count() == j.param_count()
        assert t_tf.period_of(t) == j_tf.period_of(j)
        assert t_tf.sublayer_roles(t) == j_tf.sublayer_roles(j)
        assert t_tf.num_superblocks(t) == j_tf.num_superblocks(j)
        for li in range(t.num_layers):
            assert t._layer_is_attention(li) == j._layer_is_attention(li)
            assert t._layer_is_moe(li) == j._layer_is_moe(li)
        if full:
            assert t.param_count() == PARAMS[arch]
            assert t.m_vocab <= 57_344      # the decode kernels' MAX_M
    # every block's roles as the reference lays them out
    t = tconfigs.get_smoke_config(arch)
    model = t_tf.TransformerLM(t)
    roles = j_tf.sublayer_roles(jconfigs.get_smoke_config(arch))
    assert [(b.mixer, b.ffn_kind) for b in model.blocks] == \
        [roles[i % len(roles)] for i in range(t.num_layers)]
    if arch == "mamba2-1.3b":
        assert not hasattr(model.blocks[0], "norm2")


@pytest.mark.parametrize("arch,cf", [(a, None) for a in ARCHS]
                         + [("deepseek-moe-16b", 1.0)])
def test_prefill_and_decode_match_the_reference(arch, cf):
    jcfg, tcfg, jparams, model = _pair(arch, cf=cf)
    tree = jax.tree.map(np.asarray, jparams)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(tree))
    tokens, want = _ref_prefill(arch, cf)
    with torch.inference_mode():
        got = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                            mode="prefill")
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                               rtol=0, atol=1e-5)
    if tcfg.moe is not None:
        assert float(got["aux"]) > 0
    for i, c in enumerate(got["caches"]):
        ref = _ref_cache(want["caches"], tcfg, i)
        assert set(c) == set(ref)
        for name, a in ref.items():
            np.testing.assert_allclose(c[name].numpy(), a, rtol=0,
                                       atol=1e-5, err_msg=f"{i} {name}")

    # one decode step of both rows at their own offsets (9 and 6)
    jpool = j_steps.insert_cache_slot(
        j_tf.init_lm_cache(jcfg, 2, 16, dtype=jnp.float32),
        want["caches"], 0)
    nxt = _tokens((2, 1), tcfg.vocab, seed=2)
    pos = np.array([9, 6], np.int32)
    jd = _run_jitted(lambda p, t, c, q: j_tf.lm_apply(
        p, jcfg, {"tokens": t}, mode="decode", caches=c, pos=q),
        jparams, jnp.asarray(nxt), jpool, jnp.asarray(pos))
    with torch.inference_mode():
        tpool = t_steps.insert_cache_slot(
            t_tf.init_lm_cache(tcfg, 2, 16, dtype=torch.float32),
            got["caches"], 0)
        td = t_tf.lm_apply(model, tcfg, torch.from_numpy(nxt),
                           mode="decode", caches=tpool,
                           pos=torch.from_numpy(pos).long())
    np.testing.assert_allclose(td["logits"].numpy(),
                               np.asarray(jd["logits"]), rtol=0, atol=1e-4)
    for i, c in enumerate(td["caches"]):
        for name, a in _ref_cache(jd["caches"], tcfg, i).items():
            np.testing.assert_allclose(c[name].numpy(), a, rtol=0,
                                       atol=1e-5, err_msg=f"{i} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match(arch):
    jcfg, tcfg, jparams, model = _pair(arch)
    model.train()
    tokens = _tokens((2, 12), tcfg.vocab, seed=1)

    def f(p):
        return j_tf.lm_loss_fn(j_steps.cast_params_for_compute(p, jcfg),
                               jcfg, {"tokens": jnp.asarray(tokens)})

    (jloss, jm), jgrads = _run_jitted(jax.value_and_grad(f, has_aux=True),
                                      jparams)
    loss, metrics, grads = t_steps.value_and_grad(
        model, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-4)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=0, atol=1e-4, err_msg=name)
    if tcfg.moe is not None:
        # loss = ce + w * aux / n_super (super-blocks, not MoE layers)
        assert float(loss) == pytest.approx(
            float(metrics["ce"]) + tcfg.moe.aux_loss_weight
            * float(metrics["aux"]) / t_tf.num_superblocks(tcfg), abs=1e-6)
    want = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    assert set(grads) == set(want) == set(dict(model.named_parameters()))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch,cf", [("deepseek-moe-16b", None),
                                     ("deepseek-moe-16b", 1.0),
                                     ("mamba2-1.3b", None)])
def test_engine_ids_equal_the_reference_engine(arch, cf):
    """Continuous and static, the bench's workload: every request's tokens
    and the schedule equal the JAX Engine's on the same params.  At
    capacity factor 1.0 a decode step over the 3 slots has C = 1, so
    copies are dropped and the dead slots' tokens, routed too, take
    capacity from the live ones: the port feeds them what the reference
    does."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    if cf is not None:
        jcfg, tcfg = _with_cf(jcfg, cf), _with_cf(tcfg, cf)
    jparams = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg))
    model = t_steps.cast_params_for_compute(model, tcfg).eval()
    jeng = JEngine(jcfg, jparams, n_slots=N_SLOTS, max_len=MAX_LEN,
                   topk=TOPK)
    teng = TEngine(tcfg, model, n_slots=N_SLOTS, max_len=MAX_LEN, topk=TOPK)
    for mode in ("run", "run_static"):
        tres, tst = getattr(teng, mode)(t_workload(tcfg.vocab, N_REQ,
                                                   seed=0))
        jres, jst = getattr(jeng, mode)(j_workload(jcfg.vocab, N_REQ,
                                                   seed=0))
        assert all(r.done for r in tres.values())
        assert tst.as_row() | {"wall_s": 0} == jst.as_row() | {"wall_s": 0}
        assert {r: q.tokens for r, q in tres.items()} == \
            {r: q.tokens for r, q in jres.items()}, mode
        assert len({t for q in tres.values() for t in q.tokens}) > 3


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_build_model_casts_block_by_block_to_the_same_params(arch):
    """The same seed gives bit-identical params, in the same dtypes, as
    the whole f32 model drawn and then cast (the former build_model)."""
    cfg = tconfigs.get_smoke_config(arch, dtype="bfloat16")
    got = t_serve.build_model(cfg, 5, "cpu")
    with torch.device("cpu"):
        whole = t_tf.TransformerLM(cfg, torch.Generator("cpu").manual_seed(5))
    want = t_steps.cast_params_for_compute(whole, cfg)
    sd, wd = got.state_dict(), want.state_dict()
    assert list(sd) == list(wd)
    for name, a in sd.items():
        assert a.dtype == wd[name].dtype and torch.equal(a, wd[name]), name
    assert sd["final_norm"].dtype == torch.float32
    assert sd["blocks.0.norm1"].dtype == torch.bfloat16
    assert not any(p.requires_grad for p in got.parameters())


def test_insert_cache_slot_replaces_ssm_leaves_whole():
    """A 2-row prefill (S = 9) into rows 1-2 of a 4-slot pool of 16
    positions filled with noise: the KV leaves are written at positions
    [0, 9) of those rows, the Mamba leaves (no sequence axis) replaced
    whole, the rest untouched — as the reference's insert_cache_slot."""
    jcfg, tcfg, jparams, model = _pair("jamba-v0.1-52b")
    tokens, want = _ref_prefill("jamba-v0.1-52b")
    with torch.inference_mode():
        got = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                            mode="prefill")
    rng = np.random.default_rng(6)
    jpool = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32)), j_tf.init_lm_cache(jcfg, 4, 16, dtype=jnp.float32))
    tpool = [{n: torch.from_numpy(a.copy()) for n, a in
              _ref_cache(jpool, tcfg, i).items()}
             for i in range(tcfg.num_layers)]
    jout = j_steps.insert_cache_slot(jpool, want["caches"], 1)
    tout = t_steps.insert_cache_slot(tpool, got["caches"], 1)
    assert tout is tpool
    kinds = set()
    for i, c in enumerate(tout):
        for name, a in _ref_cache(jout, tcfg, i).items():
            kinds.add(name)
            np.testing.assert_allclose(c[name].numpy(), a, rtol=0,
                                       atol=1e-5, err_msg=f"{i} {name}")
            before = _ref_cache(jpool, tcfg, i)[name]
            np.testing.assert_array_equal(c[name][[0, 3]].numpy(),
                                          before[[0, 3]])
            if name in ("k", "v"):
                np.testing.assert_array_equal(c[name][1:3, 9:].numpy(),
                                              before[1:3, 9:])
    assert kinds == {"k", "v", "ssm", "conv_x", "conv_b", "conv_c"}


def test_serve_cli_serves_the_new_families_on_cpu(capsys):
    for arch in ("mamba2-1.3b", "olmoe-1b-7b"):
        t_serve.main(["--arch", arch, "--device", "cpu", "--slots", "2",
                      "--requests", "4", "--gen", "6", "--topk", "4"])
        out = capsys.readouterr().out
        assert f"served 4 requests on 2 slots (continuous, {arch}" in out
    t_serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu", "--static",
                  "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    out = capsys.readouterr().out
    assert "whole-batch serving (jamba-v0.1-52b 8L" in out
    assert "generated ids (first seq):" in out
    # --layers cuts the depth (whole periods: deepseek's is one layer)
    t_serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                  "--static", "--layers", "1", "--batch", "2",
                  "--prompt-len", "4", "--gen", "3"])
    assert "whole-batch serving (deepseek-moe-16b 1L" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="period 8"):
        t_serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu",
                      "--static", "--layers", "4"])
    # the cut is the whole-batch path's only
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                      "--layers", "1"])
    with pytest.raises(NotImplementedError, match="A12 items 6-7"):
        tconfigs.get_config("whisper-small")
