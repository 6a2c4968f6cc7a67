"""The dense archs beyond qwen1.5-0.5b (granite-8b, phi3-mini-3.8b and
qwen3-4b, whose attention RMS-normalises q and k per head) against the JAX
package's, at smoke size (2 layers, d_model 64, vocab 512, Bloom m 128
k 3, f32), with the reference's params carried over by
``lm_params_from_jax``.

Checked: every config field both packages have and ``param_count`` (full
and smoke), the model's numel against the reference's params, the prefill
and one-step decode logits (within 1e-4) and KV caches (within 1e-5; torch
and XLA sum f32 matmuls and the softmax in another order, as in
tests/test_torch_lm.py), and the params cast to bf16 for serving, name by
name."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.configs import common as tcommon
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf

ARCHS = ("qwen3-4b", "granite-8b", "phi3-mini-3.8b")
FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
          "num_kv_heads", "d_ff", "vocab", "head_dim", "resolved_head_dim",
          "m_vocab", "qk_norm", "qkv_bias", "rope_theta", "use_rope",
          "norm_eps", "tie_embeddings", "dtype", "table_dtype", "bwd_impl")
# the reference's param_count of each full config (checked in the
# reference itself, below, so a drift of either side shows)
PARAMS = {"qwen3-4b": 3_788_167_680, "granite-8b": 7_931_727_872,
          "phi3-mini-3.8b": 3_663_399_936}


def jax_key(name: str, period: int = 1) -> str:
    """A port param name as the reference's super-block-stacked tree path:
    block i is entry i // period of ``sub{i % period}``, and a norm gain
    (``norm1``, ``q_norm``, the Mamba mixer's ``norm``) is a {"scale"}."""
    parts = name.split(".")
    if parts[0] in ("embed", "head"):
        return f"['io']['{parts[0]}']"
    if parts[0] == "final_norm":
        return "['final_norm']['scale']"
    rest = parts[2:]
    if rest[-1].startswith("norm") or rest[-1].endswith("_norm"):
        rest = rest + ["scale"]
    return f"['blocks']['sub{int(parts[1]) % period}']" + "".join(
        f"['{p}']" for p in rest)


def cast_sets(arch: str):
    """(reference bf16 paths, port bf16 paths, port f32 paths) of the
    serving cast at bf16."""
    jcfg = jconfigs.get_smoke_config(arch, dtype="bfloat16")
    tcfg = tconfigs.get_smoke_config(arch, dtype="bfloat16")
    jp = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    j_bf16 = {jax.tree_util.keystr(k) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]
              if v.dtype == jnp.bfloat16}
    model = t_steps.cast_params_for_compute(t_tf.TransformerLM(tcfg), tcfg)
    named = list(model.named_parameters())
    period = t_tf.period_of(tcfg)
    return (j_bf16,
            {jax_key(n, period) for n, p in named
             if p.dtype == torch.bfloat16},
            {jax_key(n, period) for n, p in named
             if p.dtype == torch.float32})


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_arch_matches_the_reference(arch):
    # configs and analytic sizes
    for full in (False, True):
        j = jconfigs.get_config(arch) if full else \
            jconfigs.get_smoke_config(arch)
        t = tconfigs.get_config(arch) if full else \
            tconfigs.get_smoke_config(arch)
        for f in FIELDS:
            assert getattr(t, f) == getattr(j, f), f
        assert dataclasses.asdict(t.bloom) == dataclasses.asdict(j.bloom)
        assert t.param_count() == j.param_count()
        if full:
            assert t.param_count() == PARAMS[arch]
            assert t.m_vocab <= 57_344      # the decode kernels' MAX_M
    for fn in ("with_bloom", "reduce_for_smoke"):
        kw = (dict(m_ratio=0.5, k=3) if fn == "with_bloom"
              else dict(num_layers=3))
        t = getattr(tcommon, fn)(tconfigs.get_config(arch), **kw)
        j = getattr(jcommon, fn)(jconfigs.get_config(arch), **kw)
        assert (t.m_vocab, t.num_layers, t.param_count()) == \
            (j.m_vocab, j.num_layers, j.param_count()), fn

    # the model, from the reference's params
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(tree, tcfg))
    model.eval()
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(tree))
    if tcfg.qk_norm:
        # non-trivial gains, other for q and k, so neither norm is a no-op
        rng = np.random.default_rng(1)
        shape = tree["blocks"]["sub0"]["attn"]["q_norm"]["scale"].shape
        for name in ("q_norm", "k_norm"):
            gains = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            tree["blocks"]["sub0"]["attn"][name]["scale"] = gains
            jparams["blocks"]["sub0"]["attn"][name]["scale"] = \
                jnp.asarray(gains)
        model.load_state_dict(t_tf.lm_params_from_jax(tree, tcfg))
        assert torch.equal(model.blocks[1].attn.k_norm,
                           torch.from_numpy(gains[1]))

    tokens = _tokens((2, 9), tcfg.vocab)
    want = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                         mode="prefill")
    with torch.inference_mode():
        got = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                            mode="prefill")
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=1e-4)
    for i, kv in enumerate(got["caches"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                kv[name].numpy(),
                np.asarray(want["caches"]["sub0"]["attn"][name][i]),
                rtol=0, atol=1e-5)

    # one decode step of both rows at their own offsets (9 and 6)
    jpool = j_steps.insert_cache_slot(
        j_tf.init_lm_cache(jcfg, 2, 16, dtype=jnp.float32),
        want["caches"], 0)
    nxt = _tokens((2, 1), tcfg.vocab, seed=2)
    pos = np.array([9, 6], np.int32)
    jd = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(nxt)},
                       mode="decode", caches=jpool, pos=jnp.asarray(pos))
    with torch.inference_mode():
        tpool = t_steps.insert_cache_slot(
            t_tf.init_lm_cache(tcfg, 2, 16, dtype=torch.float32),
            got["caches"], 0)
        td = t_tf.lm_apply(model, tcfg, torch.from_numpy(nxt),
                           mode="decode", caches=tpool,
                           pos=torch.from_numpy(pos).long())
    np.testing.assert_allclose(td["logits"].numpy(),
                               np.asarray(jd["logits"]), rtol=0, atol=1e-4)
    for i, kv in enumerate(td["caches"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                kv[name].numpy(),
                np.asarray(jd["caches"]["sub0"]["attn"][name][i]),
                rtol=0, atol=1e-5)

    # the serving cast at bf16: the reference's set, name by name
    j_bf16, t_bf16, t_f32 = cast_sets(arch)
    assert t_bf16 == j_bf16 and t_f32 == {"['final_norm']['scale']"}
    if tcfg.qk_norm:
        assert "['blocks']['sub0']['attn']['q_norm']['scale']" in t_bf16
