"""The token-LM serving slice as a whole: the port's qwen1.5-0.5b smoke
model (2 layers, d_model 64, vocab 512, Bloom m 128 k 3, f32) against the
JAX package's, with the reference's params carried over by
``lm_params_from_jax``.

Tolerances: the Bloom embedding within 1e-6 (the same k rows summed,
perhaps in another order); prefill and decode logits within 1e-4 and the
prefill KV caches within 1e-5, because torch and XLA sum f32 matmuls and
the softmax in another order (and the reference's prefill softmax is
flash-style, normalised after the value product).  Integers are exact:
the Engine's schedule counters equal the committed ``BENCH_serving.json``
qwen1.5-0.5b rows, continuous and static.  Per-request tokens equal the
JAX Engine's; where one differs it must be a near-tie, the reference's
own Eq. 3 scores of the two ids within 1e-4, as tests/test_torch_retrieval
checks top-k ids (and the request's later tokens are not compared).  Under
the overload policy and an injected prefill fault, the shed, degrade and
reject logs and the served tokens equal the JAX engine's too."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.bloom import decode_scores as j_decode_scores
from repro.launch import steps as j_steps
from repro.models import io as j_io
from repro.models import transformer as j_tf
from repro.serving import Engine as JEngine
from repro.serving import mixed_length_workload as j_workload
from repro_torch import configs as tconfigs
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common
from repro_torch.launch import steps as t_steps
from repro_torch.models import io as t_io
from repro_torch.models import transformer as t_tf
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.loadgen import mixed_length_workload as t_workload

from conftest import assert_slot_log_sound

ARCH, N_SLOTS, N_REQ, TOPK, MAX_LEN = "qwen1.5-0.5b", 3, 10, 4, 40
BENCH = Path(__file__).resolve().parents[1] / "BENCH_serving.json"
SCHEDULE = ("decode_steps", "slot_steps_total", "slot_steps_active",
            "tokens_out")


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(tree, tcfg))
    model = t_steps.cast_params_for_compute(model, tcfg).eval()
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, model=model)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def test_config_matches_the_reference(models):
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    for full in (False, True):
        j = jconfigs.get_config(ARCH) if full else jcfg
        t = tconfigs.get_config(ARCH) if full else tcfg
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab", "m_vocab", "resolved_head_dim",
                  "qkv_bias", "tie_embeddings", "rope_theta", "norm_eps",
                  "dtype"):
            assert getattr(t, f) == getattr(j, f), f
        assert dataclasses.asdict(t.bloom) == dataclasses.asdict(j.bloom)
        assert t.param_count() == j.param_count()
    with pytest.raises(NotImplementedError, match="A12"):
        tconfigs.get_config("qwen3-4b")
    assert tconfigs.get_config(ARCH, table_dtype="int8").table_dtype == \
        "int8"
    with pytest.raises(ValueError, match="table_dtype must be one of"):
        tconfigs.get_config(ARCH, table_dtype="int4")
    with pytest.raises(NotImplementedError, match="A12"):
        t_tf.TransformerLM(dataclasses.replace(tcfg, family="moe"))


def test_compute_cast_matches_the_reference_set():
    """The reference casts every floating param with ndim >= 2 of its
    layer-stacked tree: the per-layer norm gains and the (H, hd) QKV
    biases go to the compute dtype, the final norm's 1-D gain stays f32.
    The port casts the same set, checked name by name."""
    jcfg = jconfigs.get_smoke_config(ARCH, dtype="bfloat16")
    tcfg = tconfigs.get_smoke_config(ARCH, dtype="bfloat16")
    jp = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    j_bf16 = {jax.tree_util.keystr(k) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]
              if v.dtype == jnp.bfloat16}
    model = t_steps.cast_params_for_compute(t_tf.TransformerLM(tcfg), tcfg)

    def jax_key(name):
        parts = name.split(".")
        if parts[0] == "embed":
            return "['io']['embed']"
        if parts[0] == "final_norm":
            return "['final_norm']['scale']"
        rest = parts[2:] + (["scale"] if parts[2].startswith("norm")
                            else [])
        return "['blocks']['sub0']" + "".join(f"['{p}']" for p in rest)

    t_bf16 = {jax_key(n) for n, p in model.named_parameters()
              if p.dtype == torch.bfloat16}
    t_f32 = {jax_key(n) for n, p in model.named_parameters()
             if p.dtype == torch.float32}
    assert t_bf16 == j_bf16 and not t_bf16 & t_f32
    assert "['blocks']['sub0']['attn']['bq']" in t_bf16
    assert t_f32 == {"['final_norm']['scale']"}


def test_embed_tokens_matches(models):
    tokens = _tokens((2, 7), models["tcfg"].vocab)
    want = j_io.embed_tokens(models["jparams"]["io"], models["jcfg"],
                             jnp.asarray(tokens))
    with torch.no_grad():
        got = t_io.embed_tokens(models["model"].embed, models["tcfg"],
                                torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_prefill_and_decode_logits_and_caches_match(models):
    jcfg, tcfg, jparams, model = (models[k] for k in
                                  ("jcfg", "tcfg", "jparams", "model"))
    tokens = _tokens((1, 9), tcfg.vocab)
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

    # one decode step of a 2-slot pool: slot 1 holds this prompt at pos 9,
    # slot 0 a shorter prompt at pos 4
    short = _tokens((1, 4), tcfg.vocab, seed=1)
    j_short = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(short)},
                            mode="prefill")
    pool = j_tf.init_lm_cache(jcfg, 2, 16, dtype=jnp.float32)
    pool = j_steps.insert_cache_slot(pool, j_short["caches"], 0)
    pool = j_steps.insert_cache_slot(pool, want["caches"], 1)
    nxt = _tokens((2, 1), tcfg.vocab, seed=2)
    pos = np.array([4, 9], np.int32)
    jd = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(nxt)},
                       mode="decode", caches=pool, pos=jnp.asarray(pos))
    with torch.inference_mode():
        t_short = t_tf.lm_apply(model, tcfg, torch.from_numpy(short),
                                mode="prefill")
        tpool = t_tf.init_lm_cache(tcfg, 2, 16, dtype=torch.float32)
        t_steps.insert_cache_slot(tpool, t_short["caches"], 0)
        t_steps.insert_cache_slot(tpool, got["caches"], 1)
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


def test_dense_vocab_and_untied_head_match_the_reference():
    """Bloom off (the embedding is a plain (vocab, D) lookup, recovery a
    stable top-k of the logits) and an untied (D, vocab) head."""
    over = dict(tie_embeddings=False, vocab=96)
    jcfg = jconfigs.get_smoke_config(
        ARCH, bloom=jconfigs.BloomConfig(enabled=False), **over)
    tcfg = tconfigs.get_smoke_config(
        ARCH, bloom=tconfigs.BloomConfig(enabled=False), **over)
    jparams = j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(1))
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg))
    tokens = _tokens((2, 6), tcfg.vocab, seed=3)
    want = j_tf.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                         mode="prefill")["logits"]
    with torch.inference_mode():
        got = t_tf.lm_apply(model, tcfg, torch.from_numpy(tokens),
                            mode="prefill")["logits"]
    assert got.shape == (2, 6, 96) and model.head is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    _, jids = j_io.recover_topk(jcfg, want[:, -1], topk=5)
    _, tids = t_io.recover_topk(tcfg, got[:, -1], topk=5)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.fixture(scope="module")
def served(models):
    jeng = JEngine(models["jcfg"], models["jparams"], n_slots=N_SLOTS,
                   max_len=MAX_LEN, topk=TOPK)
    teng = TEngine(models["tcfg"], models["model"], n_slots=N_SLOTS,
                   max_len=MAX_LEN, topk=TOPK)
    out = {"teng": teng, "jparams": models["jparams"], "jcfg": models["jcfg"]}
    for mode in ("run", "run_static"):
        common.reset_launches()
        out[mode] = getattr(teng, mode)(
            t_workload(models["tcfg"].vocab, N_REQ, seed=0))
        out[mode + "_launches"] = dict(common.LAUNCHES)
        out[mode + "_ref"] = getattr(jeng, mode)(
            j_workload(models["jcfg"].vocab, N_REQ, seed=0))
    return out


@pytest.mark.parametrize("mode,row", [("run", "continuous"),
                                      ("run_static", "static")])
def test_schedule_equals_the_committed_bench_rows(served, mode, row):
    rows = {r["name"]: r for r in json.loads(BENCH.read_text())["rows"]}
    want = rows[f"{ARCH}.{row}"]
    assert (want["n_slots"], want["n_requests"], want["seed"]) == \
        (N_SLOTS, N_REQ, 0)
    results, stats = served[mode]
    assert all(r.done for r in results.values())
    for f in SCHEDULE:
        assert getattr(stats, f) == want[f], f
    assert round(stats.utilization, 4) == want["utilization"]
    _, jstats = served[mode + "_ref"]
    assert stats.as_row() | {"wall_s": 0} == jstats.as_row() | {"wall_s": 0}
    if mode == "run":
        assert_slot_log_sound(served["teng"]._sched, N_SLOTS)


@pytest.mark.parametrize("case", ["overload", "prefill_reject"])
def test_policy_and_faults_schedule_like_the_reference(models, case):
    """The LM engine under the overload policy (surge + slow decode,
    deadlines: sheds and the degrade ladder) and under an injected
    prefill fault at the attempt cap (a REJECT, 2 workers): the shed and
    degrade logs, the rejects, the stats and every served token equal the
    JAX engine's on the same params."""
    from repro.serving import AdmissionPolicy as JPolicy
    from repro.serving import FailPlan as JFailPlan
    from repro_torch.serving.admission import AdmissionPolicy as TPolicy
    from repro_torch.serving.failpoints import (PREFILL_MAX_ATTEMPTS,
                                                FailPlan as TFailPlan)
    if case == "overload":
        plan = "surge:3@1,slow_decode:3@2"
        pol = dict(max_queue_depth=2, pressure_window=2, degrade_lo=0.25,
                   degrade_hi=0.5, restore_below=0.1)
        kw = lambda P: dict(admission_policy=P(**pol))   # noqa: E731
    else:
        plan = f"fail_prefill:0:{PREFILL_MAX_ATTEMPTS}"
        kw = lambda P: dict(prefill_workers=2)           # noqa: E731
    runs = []
    for Eng, F, P, wl, cfg, params in (
            (TEngine, TFailPlan, TPolicy, t_workload, models["tcfg"],
             models["model"]),
            (JEngine, JFailPlan, JPolicy, j_workload, models["jcfg"],
             models["jparams"])):
        eng = Eng(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, topk=TOPK,
                  failpoints=F.parse(plan), **kw(P))
        reqs = wl(cfg.vocab, N_REQ, seed=0)
        for r in reqs:
            r.deadline_step = r.arrival_step + 6
        res, st = eng.run(reqs)
        runs.append((res, st, eng._sched))
    (tres, tst, tsched), (jres, jst, jsched) = runs
    if case == "overload":
        assert tst.sheds > 0 and tst.degrades >= 2
    else:
        assert tst.rejects == 1 and tres[0].rejected
    assert (tst.as_row() | {"wall_s": 0}, tst.sheds, tst.degrades) == \
        (jst.as_row() | {"wall_s": 0}, jst.sheds, jst.degrades)
    assert (tsched.sheds, tsched.degrades, tsched.rejects) == \
        (jsched.sheds, jsched.degrades, jsched.rejects)
    assert {r: q.tokens for r, q in tres.items()} == \
        {r: q.tokens for r, q in jres.items()}
    assert_slot_log_sound(tsched, N_SLOTS)


def _ref_scores(jparams, jcfg, seq):
    """The reference's Eq. 3 scores of every vocab id after ``seq``."""
    logits = j_tf.lm_apply(jparams, jcfg,
                           {"tokens": jnp.asarray([seq], jnp.int32)},
                           mode="prefill")["logits"][0, -1]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return np.asarray(j_decode_scores(j_io.vocab_spec(jcfg), logp[None]))[0]


@pytest.mark.parametrize("mode", ["run", "run_static"])
def test_tokens_equal_the_reference_up_to_near_ties(served, mode):
    results, _ = served[mode]
    jres, _ = served[mode + "_ref"]
    for rid, req in results.items():
        want = jres[rid].tokens
        assert len(req.tokens) == len(want)
        for i, (a, b) in enumerate(zip(req.tokens, want)):
            if a != b:
                s = _ref_scores(served["jparams"], served["jcfg"],
                                list(req.prompt) + want[:i])
                assert abs(s[a] - s[b]) <= 1e-4, (rid, i, a, b)
                break


@pytest.mark.parametrize("mode", ["run", "run_static"])
def test_cpu_serving_launches_no_kernel(served, mode):
    launches = served[mode + "_launches"]
    assert launches.get(be.NAME, 0) == 0 and launches.get(dt.NAME, 0) == 0


def test_static_and_continuous_serve_the_same_tokens(served):
    cont, _ = served["run"]
    stat, _ = served["run_static"]
    assert {r: q.tokens for r, q in cont.items()} == \
        {r: q.tokens for r, q in stat.items()}


def test_serve_cli_serves_every_request_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--slots", "3",
                "--requests", "10", "--topk", "4"])
    assert "served 10 requests on 3 slots (continuous" in \
        capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A13"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--sharded"])
    with pytest.raises(ValueError, match="table_dtype must be one of"):
        serve.main(["--arch", ARCH, "--device", "cpu",
                    "--table-dtype", "int4"])


def test_embed_kernel_path_refuses_grad_on_cuda_tensors_only():
    """On the CPU a grad-requiring table takes the differentiable plain
    version; the CUDA wrapper's forward-only refusal is checked on the
    card (tests/test_torch_cuda.py)."""
    table = torch.randn(32, 8, requires_grad=True)
    out = t_io.embed_tokens(table, tconfigs.get_smoke_config(
        ARCH, vocab=100, bloom=tconfigs.BloomConfig(True, 0.32, 2)),
        torch.tensor([[1, 2, 3]]))
    out.sum().backward()
    assert table.grad is not None and table.grad.abs().sum() > 0
