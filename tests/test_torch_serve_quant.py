"""Quantized-table serving (``table_dtype``) as a whole, the port against the
JAX package on the same inputs.

Retrieval: the smoke preset with ``table_dtype="int8"``, 4 slots, 10
requests, the reference's tower weights loaded into the port.  The slot
log, the stats and the modeled-bytes integers are equal; the top-k ids are
equal and the scores within 1e-4 (the towers' f32 matmuls sum in another
order, ~1e-5); ``evaluate_retrieval(table_dtype="int8")`` agrees within
1e-6.

LM: the qwen1.5-0.5b smoke model with the reference's params, the
reference on its Pallas IO path (``io_impl="pallas"``, interpret mode) and
``table_dtype`` int8 and fp8_e4m3.  The schedule integers are equal, and
every served token is equal up to a near tie: where the port's token and
the reference's differ, the reference's own Eq. 3 scores (over its
quantized logp rows) of the two ids are within k quantization steps of the
row (the int8 scale, or the fp8 spacing at the row's largest magnitude),
and the request's later tokens are not compared.  The serving and training
CLIs take ``--table-dtype`` on the CPU and launch no kernel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_retrieval_config as j_rconfig
from repro.core import quant as jquant
from repro.core.bloom import decode_scores as j_decode_scores
from repro.launch import steps as j_steps
from repro.models import io as j_io
from repro.models import transformer as j_tf
from repro.serving import Engine as JEngine
from repro.serving import loadgen as j_loadgen
from repro.serving import mixed_length_workload as j_workload
from repro.serving import retrieval as j_ret
from repro_torch import configs as tconfigs
from repro_torch.configs.retrieval import get_retrieval_config as t_rconfig
from repro_torch.kernels import common
from repro_torch.launch import steps as t_steps
from repro_torch.models import io as t_io
from repro_torch.models import transformer as t_tf
from repro_torch.models.recommender import params_from_jax
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.serving import retrieval as t_ret
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.loadgen import mixed_length_workload as t_workload

from conftest import assert_slot_log_sound

N_SLOTS, N_REQ = 4, 10
ARCH, LM_SLOTS, TOPK, MAX_LEN = "qwen1.5-0.5b", 3, 4, 40


def _stats(st):
    return {f: getattr(st, f) for f in (
        "decode_steps", "idle_steps", "slot_steps_total",
        "slot_steps_active", "prefills", "tokens_out", "compactions",
        "host_downs", "requeued", "rejects", "sheds", "degrades")}


@pytest.fixture(scope="module")
def retrieval_int8():
    jcfg = j_rconfig("smoke", table_dtype="int8")
    tcfg = t_rconfig("smoke", table_dtype="int8")
    jparams = j_ret.init_retrieval_params(jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    load = dict(n_requests=N_REQ, catalog=jcfg.d, c_max=jcfg.c_max,
                rate=2.0, seed=0)
    jwl = j_loadgen.retrieval_workload(j_loadgen.RetrievalLoadSpec(**load))
    twl = t_loadgen.retrieval_workload(t_loadgen.RetrievalLoadSpec(**load))
    jeng = j_ret.RetrievalEngine(jcfg, jparams, n_slots=N_SLOTS)
    teng = t_ret.RetrievalEngine(tcfg, tparams, n_slots=N_SLOTS)
    jres, jst = jeng.run([r.fresh_copy() for r in jwl])
    common.reset_launches()
    tres, tst = teng.run([r.fresh_copy() for r in twl])
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jeng=jeng, teng=teng, jres=jres, jst=jst, tres=tres,
                tst=tst, launches=dict(common.LAUNCHES))


def test_retrieval_int8_schedule_and_bytes_equal_the_reference(
        retrieval_int8):
    r = retrieval_int8
    assert r["teng"]._sched.admissions == r["jeng"]._sched.admissions
    assert r["teng"]._sched.releases == r["jeng"]._sched.releases
    assert _stats(r["tst"]) == _stats(r["jst"])
    mb_t, mb_j = r["teng"].modeled_bytes, r["jeng"].modeled_bytes
    for key in mb_j:
        assert mb_t[key] == mb_j[key], key
    # the narrow bytes model: no (d, k) stream, 1-byte rows, row scales
    auto = t_ret.RetrievalEngine(t_rconfig("smoke"), r["tparams"],
                                 n_slots=N_SLOTS)
    auto.run([q.fresh_copy() for q in r["tres"].values()])
    assert mb_t["streaming_bytes"] < auto.modeled_bytes["streaming_bytes"]
    assert mb_t["min_bytes"] < auto.modeled_bytes["min_bytes"]
    assert_slot_log_sound(r["teng"]._sched, N_SLOTS)
    assert r["launches"] == {}              # CPU tensors: the plain version


def test_retrieval_int8_topk_ids_equal_the_reference(retrieval_int8):
    r = retrieval_int8
    for rid, jr in r["jres"].items():
        tr = r["tres"][rid]
        assert tr.done and not tr.rejected
        assert tr.topk_ids == jr.topk_ids, rid
        np.testing.assert_allclose(tr.topk_scores, jr.topk_scores, rtol=0,
                                   atol=1e-4)


def test_retrieval_int8_eval_matches_the_reference(retrieval_int8):
    r = retrieval_int8
    for td in ("int8", None):
        want = j_ret.evaluate_retrieval(r["jcfg"], r["jparams"],
                                        list(r["jres"].values()),
                                        table_dtype=td)
        got = t_ret.evaluate_retrieval(r["tcfg"], r["tparams"],
                                       list(r["tres"].values()),
                                       table_dtype=td)
        assert got["n_evaluated"] == want["n_evaluated"] == N_REQ
        for key in ("map", "rr", "accuracy"):
            assert got[key] == pytest.approx(want[key], abs=1e-6), (td, key)


def test_retrieval_decode_step_reads_no_hash_matrix_when_quantized():
    from repro_torch.core import bloom as bloom_lib
    rcfg = t_rconfig("smoke", d=12_345, table_dtype="int8")
    bloom_lib._cached_hash_matrix.cache_clear()
    step = t_steps.make_retrieval_decode_step(rcfg, "cpu")
    pool = torch.randn(3, rcfg.m)
    step(pool, torch.tensor([True, False, True]))
    assert bloom_lib._cached_hash_matrix.cache_info().currsize == 0
    t_steps.make_retrieval_decode_step(t_rconfig("smoke", d=12_345), "cpu")
    assert bloom_lib._cached_hash_matrix.cache_info().currsize == 1


@pytest.fixture(scope="module")
def lm_models():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams = j_steps.cast_params_for_compute(
        j_steps.init_fn_for(jcfg)(jax.random.PRNGKey(0)), jcfg)
    model = t_tf.TransformerLM(tcfg)
    model.load_state_dict(t_tf.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg))
    model = t_steps.cast_params_for_compute(model, tcfg).eval()
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, model=model)


@pytest.fixture(scope="module", params=["int8", "fp8_e4m3"])
def lm_served(request, lm_models):
    td = request.param
    jcfg = dataclasses.replace(lm_models["jcfg"], io_impl="pallas",
                               table_dtype=td)
    tcfg = dataclasses.replace(lm_models["tcfg"], table_dtype=td)
    jeng = JEngine(jcfg, lm_models["jparams"], n_slots=LM_SLOTS,
                   max_len=MAX_LEN, topk=TOPK)
    teng = TEngine(tcfg, lm_models["model"], n_slots=LM_SLOTS,
                   max_len=MAX_LEN, topk=TOPK)
    common.reset_launches()
    tres, tst = teng.run(t_workload(tcfg.vocab, N_REQ, seed=0))
    launches = dict(common.LAUNCHES)
    jres, jst = jeng.run(j_workload(jcfg.vocab, N_REQ, seed=0))
    return dict(td=td, jcfg=jcfg, tcfg=tcfg, jparams=lm_models["jparams"],
                tres=tres, tst=tst, jres=jres, jst=jst, teng=teng,
                launches=launches)


def test_lm_quantized_schedule_equals_the_reference(lm_served):
    s = lm_served
    assert all(r.done for r in s["tres"].values())
    assert s["tst"].as_row() | {"wall_s": 0} == \
        s["jst"].as_row() | {"wall_s": 0}
    assert_slot_log_sound(s["teng"]._sched, LM_SLOTS)
    assert s["launches"] == {}               # CPU tensors: plain versions


def _ref_quant_scores(jparams, jcfg, seq, td):
    """The reference's Eq. 3 scores of every vocab id after ``seq``, over
    its quantized logp row, and the row's quantization step."""
    logits = j_tf.lm_apply(jparams, jcfg,
                           {"tokens": jnp.asarray([seq], jnp.int32)},
                           mode="prefill")["logits"][0, -1]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))[None]
    q, s = jquant.quantize_table(logp, td)
    deq = jquant.dequantize_table(q, s)
    scores = np.asarray(j_decode_scores(j_io.vocab_spec(jcfg), deq))[0]
    if s is not None:
        step = float(s[0])
    else:         # fp8 e4m3: 3 mantissa bits at the row's largest exponent
        step = 2.0 ** (np.floor(np.log2(float(jnp.abs(logp).max()))) - 3)
    return scores, step


def test_lm_quantized_tokens_equal_the_reference_up_to_near_ties(lm_served):
    s = lm_served
    k = s["tcfg"].bloom.k
    for rid, req in s["tres"].items():
        want = s["jres"][rid].tokens
        assert len(req.tokens) == len(want)
        for i, (a, b) in enumerate(zip(req.tokens, want)):
            if a != b:
                scores, step = _ref_quant_scores(
                    s["jparams"], s["jcfg"], list(req.prompt) + want[:i],
                    s["td"])
                assert abs(scores[a] - scores[b]) <= k * step, \
                    (rid, i, a, b, scores[a], scores[b], step)
                break


def test_lm_quantized_embed_matches_the_reference_io(lm_models):
    """embed_tokens with a quantized table: the port (master table in,
    cfg.dtype out) against the reference's Pallas IO path within 1e-6."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, lm_models["tcfg"].vocab, size=(2, 7))
    for td in ("int8", "fp8_e4m3", "bfloat16"):
        jcfg = dataclasses.replace(lm_models["jcfg"], io_impl="pallas",
                                   table_dtype=td)
        tcfg = dataclasses.replace(lm_models["tcfg"], table_dtype=td)
        want = j_io.embed_tokens(lm_models["jparams"]["io"], jcfg,
                                 jnp.asarray(tokens, jnp.int32))
        with torch.inference_mode():
            got = t_io.embed_tokens(lm_models["model"].embed, tcfg,
                                       torch.from_numpy(tokens))
        assert got.dtype == getattr(torch, tcfg.dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_serve_cli_serves_every_request_with_a_quantized_table(capsys):
    """Continuous serving with an int8 table, and the whole-batch path
    (``--static --batch``) with an fp8 table, on the CPU: no launch."""
    from repro_torch.launch import serve
    for td, extra in (("int8", []),
                      ("fp8_e4m3", ["--static", "--batch", "3",
                                    "--prompt-len", "8", "--gen", "5"])):
        common.reset_launches()
        serve.main(["--arch", ARCH, "--device", "cpu", "--slots", "3",
                    "--requests", "10", "--topk", "4", "--table-dtype", td,
                    *extra])
        out = capsys.readouterr().out
        if extra:
            assert "prefill 8 toks x3:" in out and "decode  4 steps:" in out
            ids = out.split("generated ids (first seq): ")[1].splitlines()[0]
            assert len(ids.strip("[]").split(",")) == 5
        else:
            assert "served 10 requests on 3 slots" in out
        assert f"table_dtype {td}" in out and common.LAUNCHES == {}


def test_train_runs_with_a_quantized_table_on_the_cpu():
    from repro_torch.launch import train
    common.reset_launches()
    model, hist = train.run(ARCH, steps=6, batch=2, seq=8, log_every=1,
                            table_dtype="int8", device="cpu")
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert common.LAUNCHES == {}
