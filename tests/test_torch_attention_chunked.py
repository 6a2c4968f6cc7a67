"""The port's chunked flash-style attention and its remat policy
(``models/attention.py``, ``transformer.remat_apply``, ``encdec``) held
against the JAX package on the same numpy inputs, drawn from a seed.

* ``chunked_attention`` against the reference's: causal and not, GQA
  (KV = 2 heads read by G = 2 query heads each) and MHA, a key count that
  is not a multiple of the chunk (the last chunk padded), a ``kv_valid``
  mask with a fully masked row, chunks of 1, 3 and 16 keys.  f32: the
  forward within 1e-6, the flash backward (``_FlashAttention``) within
  1e-5 of ``jax.vjp`` of the reference's custom VJP.
* ``causal_skip`` within 1e-6 of the reference's (its gradients within
  1e-5); S not a multiple of ``chunk_q`` raises; ``naive_attention``
  within 1e-6 of the reference's; ``bf16_scores`` on bf16 inputs within
  the reference's 2e-2 of the f32 oracle, a fully masked row exactly 0
  on both sides.
* Remat: ``lm_loss_fn`` / ``encdec_loss_fn`` loss and gradients with
  ``remat`` none, full and dots are equal bit for bit, and within 1e-4
  (the reference's own gradient tolerance) of ``jax.grad`` of the
  reference with the same knob: qwen1.5-0.5b (dense; all three knobs),
  olmoe-1b-7b (the MoE's auxiliary loss through the checkpoint; dots),
  jamba cut to one super-block of two layers (a Mamba and an
  attention-and-MoE layer; full) and whisper-small (the encoder's and
  the decoder's blocks; none).
* The dry run counts each op once under the checkpoints (its FLOPs equal
  an outermost count of the matmuls that ran): with ``remat="full"`` the
  recompute adds at most one forward of the blocks, with ``"dots"`` none
  of the kept batch-free products; with the defaults a train step's
  temporaries are fewer than with ``attn_impl="naive", remat="none"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tf

B, S, T, KV, HD = 2, 12, 13, 2, 8


def _inputs(G=2, S=S, T=T, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KV, G, HD)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, HD)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S, KV, G, HD)).astype(np.float32)
    # the queries are the last S of the T positions
    q_pos = np.broadcast_to(np.arange(T - S, T), (B, S)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    return q, k, v, do, q_pos, kv_pos


def _valid():
    """Row 0: every third key masked; row 1: every key masked."""
    valid = np.ones((B, T), bool)
    valid[0, ::3] = False
    valid[1] = False
    return valid


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _port(fn, q, k, v, do, **kw):
    """fn's output and its q, k, v gradients for the cotangent do."""
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = fn(qt, kt, vt, **kw)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _ref(fn, q, k, v, do, **kw):
    """The reference's output and vjp, in one jitted program."""
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw), q, k, v)
        return out, vjp(do)

    out, grads = jax.jit(run)(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _held(got, want, fwd_tol, bwd_tol):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=fwd_tol)
    for g, w, name in zip(got[1], want[1], "qkv"):
        np.testing.assert_allclose(g, w, rtol=0, atol=bwd_tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("G,masked", [(2, False), (1, False), (2, True)],
                         ids=["gqa", "mha", "gqa-kv_valid"])
def test_chunked_forward_and_backward_match_the_reference(causal, chunk, G,
                                                          masked):
    q, k, v, do, q_pos, kv_pos = _inputs(G)
    valid = _valid() if masked else None
    got = _port(t_attn.chunked_attention, q, k, v, do, causal=causal,
                chunk_k=chunk, q_pos=_t(q_pos), kv_pos=_t(kv_pos),
                kv_valid=_t(valid))
    want = _ref(j_attn.chunked_attention, q, k, v, do, causal=causal,
                chunk_k=chunk, q_pos=jnp.asarray(q_pos),
                kv_pos=jnp.asarray(kv_pos),
                kv_valid=None if valid is None else jnp.asarray(valid))
    assert np.abs(want[0]).max() > 0.1
    _held(got, want, 1e-6, 1e-5)


@pytest.mark.parametrize("chunk_q,chunk_k", [(4, 3), (16, 16), (8, 4)])
def test_causal_skip_matches_the_reference(chunk_q, chunk_k):
    q, k, v, do, q_pos, kv_pos = _inputs(S=16, T=16, seed=1)
    kw = dict(chunk_q=chunk_q, chunk_k=chunk_k)
    got = _port(t_attn.chunked_attention_causal_skip, q, k, v, do,
                q_pos=_t(q_pos), kv_pos=_t(kv_pos), **kw)
    want = _ref(j_attn.chunked_attention_causal_skip, q, k, v, do,
                q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), **kw)
    _held(got, want, 1e-6, 1e-5)
    with pytest.raises(ValueError, match="S % chunk_q"):
        t_attn.chunked_attention_causal_skip(
            *map(_t, (q, k, v)), chunk_q=5, chunk_k=chunk_k,
            q_pos=_t(q_pos), kv_pos=_t(kv_pos))


@pytest.mark.parametrize("causal", [True, False])
def test_naive_oracle_matches_the_reference(causal):
    q, k, v, do, q_pos, kv_pos = _inputs(seed=2)
    valid = _valid()
    got = _port(t_attn.naive_attention, q, k, v, do, causal=causal,
                q_pos=_t(q_pos), kv_pos=_t(kv_pos), kv_valid=_t(valid))
    want = _ref(j_attn.naive_attention, q, k, v, do, causal=causal,
                q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                kv_valid=jnp.asarray(valid))
    _held(got, want, 1e-6, 1e-5)


def test_bf16_scores_within_the_reference_tolerance_of_the_f32_oracle():
    q, k, v, _, q_pos, kv_pos = _inputs(S=16, T=16, seed=3)
    valid = np.ones((B, 16), bool)
    valid[1] = False
    oracle = np.asarray(j_attn.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos)))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    for kv_valid, rows in ((None, slice(None)), (valid, slice(0, 1))):
        got = t_attn.chunked_attention(
            *bf, causal=True, chunk_k=4, q_pos=_t(q_pos), kv_pos=_t(kv_pos),
            kv_valid=_t(kv_valid), bf16_scores=True)
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy()[rows] - oracle[rows]).max()
        assert diff < 2e-2, diff
    want = j_attn.chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        chunk_k=4, q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(valid), bf16_scores=True)
    # the fully masked row: lse = inf, out = 0, on both sides
    assert not got[1].float().any() and not np.asarray(
        want[1].astype(jnp.float32)).any()
    bf = [t.requires_grad_() for t in bf]
    out = t_attn.chunked_attention(
        *bf, causal=True, chunk_k=4, q_pos=_t(q_pos), kv_pos=_t(kv_pos),
        kv_valid=_t(valid), bf16_scores=True)
    grads = torch.autograd.grad(out.float().sum(), bf)
    assert all(torch.isfinite(g.float()).all() for g in grads)
    assert not grads[0][1].float().any()


@pytest.mark.parametrize("field,value", [
    ("remat", "some"), ("attn_impl", "flash"), ("attn_chunk_q", 0),
    ("attn_chunk_k", 1.5), ("causal_skip", "yes"),
    ("attn_bf16_scores", 1)])
def test_a_bad_execution_knob_raises(field, value):
    cfg = tconfigs.get_smoke_config("qwen1.5-0.5b")
    assert (cfg.remat, cfg.attn_impl, cfg.attn_chunk_q, cfg.attn_chunk_k,
            cfg.causal_skip, cfg.attn_bf16_scores) == (
        "full", "chunked", 16, 16, False, False)
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(cfg, **{field: value})


def test_prefill_is_chunked_whatever_attn_impl_says(monkeypatch):
    """``attn_impl="naive"`` reaches the oracle in training only."""
    cfg = tconfigs.get_smoke_config("qwen1.5-0.5b", attn_impl="naive")
    model = t_tf.TransformerLM(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    calls = []
    real = t_attn.naive_attention
    monkeypatch.setattr(t_attn, "naive_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        pre = t_tf.lm_apply(model, cfg, tokens, mode="prefill")
        assert calls == []
        train = t_tf.lm_apply(model, cfg, tokens, mode="train")
    assert len(calls) == cfg.num_layers
    torch.testing.assert_close(pre["logits"], train["logits"], rtol=0,
                               atol=1e-5)


# jamba cut to one super-block of two layers: a Mamba mixer and a dense
# FFN, then attention and the MoE FFN
JAMBA_2 = {"num_layers": 2, "attn_layer_period": 2, "attn_layer_offset": 1}
# each arch with the reference's remat knobs it is held to (its own three
# are bit-equal): qwen all three, the others one each, for the file's time
ARCHS = [("qwen1.5-0.5b", {}, ("none", "full", "dots")),
         ("olmoe-1b-7b", {}, ("dots",)),
         ("jamba-v0.1-52b", JAMBA_2, ("full",)),
         ("whisper-small", {}, ("none",))]


@pytest.mark.parametrize("arch,over,held", ARCHS, ids=[a[0] for a in ARCHS])
def test_remat_grads_are_bit_equal_and_match_jax_grad(arch, over, held):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = tconfigs.get_smoke_config(arch, **over)
    assert t_tf.period_of(tcfg) == (2 if over else 1)
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0))
    cls = t_steps.model_class_for(tcfg)
    sd = t_tf.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, cls)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (2, 20)).astype(np.int32)}
    if tcfg.family == "audio":
        batch["embeds"] = rng.standard_normal((2, 24, tcfg.d_model)).astype(
            np.float32)
    tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    got = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = cls(cfg)
        model.load_state_dict(sd)
        loss, metrics, grads = t_steps.value_and_grad(model, cfg, tbatch)
        got[remat] = (loss, metrics["aux"], grads)
        if remat not in held:
            continue
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            j_steps.loss_fn_for(dataclasses.replace(jcfg, remat=remat)),
            has_aux=True)).lower(jparams, jbatch).compile(
            compiler_options={"xla_backend_optimization_level": 0})(
            jparams, jbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                                   rtol=0, atol=1e-4)
        want = t_tf.params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                                    cls)
        assert set(grads) == set(want)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{remat} {name}")
    if tcfg.moe is not None:
        assert float(got["none"][1]) > 0
    for remat in ("full", "dots"):
        assert torch.equal(got[remat][0], got["none"][0])
        assert torch.equal(got[remat][1], got["none"][1])
        for name, g in got["none"][2].items():
            assert torch.equal(got[remat][2][name], g), (remat, name)


class _Products(TorchDispatchMode):
    """Counts the matmul calls by kind (``mm``, ``addmm``, a ``bmm`` over
    a batch of one, a batched ``bmm``) and their FLOPs."""

    def __init__(self):
        super().__init__()
        self.calls = dict.fromkeys(("mm", "addmm", "bmm1", "bmm"), 0)
        self.flops = dict.fromkeys(self.calls, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        kind = {aten.mm.default: "mm", aten.addmm.default: "addmm",
                aten.bmm.default: "bmm"}.get(func)
        if kind is not None:
            a, b = args[-2:]
            if kind == "bmm" and a.shape[0] == 1:
                kind = "bmm1"
            self.calls[kind] += 1
            self.flops[kind] += 2 * a.numel() * b.shape[-1]
        return out


def _counted(cfg, tokens):
    """The dry run's count (``count_step``) of one train step's loss and
    gradients, and its ``_Products``, outermost."""
    model = t_tf.TransformerLM(cfg, torch.Generator().manual_seed(0))
    transport = type("T", (), {"calls": []})()
    with _Products() as products:
        res = dryrun.count_step(
            lambda: t_steps.value_and_grad(model, cfg, {"tokens": tokens}),
            dict(model.named_parameters()), transport)
    return res, products


def test_the_dry_run_counts_each_op_once_under_the_checkpoints():
    """Beneath an outermost count, the dry run's counters (and under
    ``"dots"`` the selective checkpoint's own dispatch mode inside them)
    see each matmul once, as it runs: the backward's recompute re-runs at
    most one forward of the blocks (it stops after the last tensor the
    backward needs), ``"dots"`` none of the kept batch-free products and
    every batched one that ``"full"`` re-runs."""
    base = tconfigs.get_smoke_config("qwen3-4b")
    tokens = torch.randint(0, base.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    counts = {r: _counted(dataclasses.replace(base, remat=r), tokens)
              for r in ("none", "full", "dots")}
    model = t_tf.TransformerLM(base, torch.Generator().manual_seed(0))
    x = torch.randn(2, 40, base.d_model)
    positions = torch.arange(40).expand(2, 40)
    with torch.no_grad(), _Products() as fwd:     # one forward of the blocks
        for i, blk in enumerate(model.blocks):
            t_tf._superblock_apply([blk], i, base, x, positions, "train",
                                   None, None, None)
    for res, products in counts.values():
        assert res["flops_dev"] == sum(products.flops.values())
    none, full, dots = (counts[r][1] for r in ("none", "full", "dots"))
    for kind in ("mm", "bmm1", "bmm"):
        assert 0 < full.calls[kind] - none.calls[kind] <= fwd.calls[kind]
    for kind in ("mm", "addmm", "bmm1"):
        assert dots.calls[kind] == none.calls[kind], kind
    assert dots.calls["bmm"] == full.calls["bmm"]
    flops = [counts[r][0]["flops_dev"] for r in ("none", "dots", "full")]
    assert flops == sorted(set(flops))


def test_the_defaults_count_fewer_temporaries_than_naive_without_remat(
        monkeypatch):
    full = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config",
                        lambda a, bloom=True, **o: dataclasses.replace(
                            full(a, bloom=bloom, **o), num_layers=2))
    temp = {}
    for name, over in (("defaults", {}),
                       ("naive", {"attn_impl": "naive", "remat": "none"})):
        res = dryrun.run_cell("qwen1.5-0.5b", "train_4k", out_dir=None,
                              roofline_pass=False, overrides=over)
        temp[name] = res["full"]["memory"]["temp_bytes"]
        assert res["execution"]["attn_impl"] == over.get("attn_impl",
                                                         "chunked")
    assert 0 < temp["defaults"] < temp["naive"] / 1.5, temp
