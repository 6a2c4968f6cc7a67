"""Decode under a mesh: whole-batch generation over gloo CPU ranks
(``launch/serve.decode_job``: prefill, then ``make_decode_step(cfg, topk,
device, dist)`` against each rank's cache shards, the vocab-parallel
logits gathered whole before the Eq. 3 top-k), against the JAX
package's single-device ``make_prefill_step`` / ``make_decode_step`` on
the same weights and prompts.

Cases: a dense smoke config (qwen3-4b: 4 heads, 2 kv heads, untied Bloom
head, m 128) on 1x2 (its kv heads split) and on 2x2 (rows split too); a
GQA config whose kv heads do not divide the model axis (the same with 1
kv head on 1x2, and with 2 on 1x4: the cache replicated over ``model``,
each rank's q heads reading their kv head); an MoE smoke config
(olmoe-1b-7b) expert-parallel on 1x2 and dense on 2x1 (routing the
global batch).  In each, the generated tokens and every step's top-k ids
equal the reference's, and the logits and top-k scores agree within
1e-5: the ranks sum the row-parallel products and the vocab-parallel
embedding in another order than one device does.  Both sides keep their
decode caches in f32 here (the serving default is bf16, where such an
order difference can round a cached k or v element to the neighbouring
bf16 value and move a logit by ~1e-4, on one device as on many).  The
serve CLI's ``--mesh 1x2`` prints the reference ``serve.run``'s tokens on
the same weights (bf16 caches on both sides).

Two ids whose reference scores tie within 2e-5 may come in either order;
a row whose greedy token falls on such a tie is fed another token from
then on and is compared no further (at most one row a case).

Each multi-rank test bounds its ranks' runs (``spawn``'s ``timeout``, the
time left of 85 s from the test's start)."""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import io as j_io
from repro.models import transformer as j_tf
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf

from conftest import subprocess_env

GEN, TOPK = 5, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _deadline():
    """Seconds left, from each call, of the test's 85 s."""
    end = time.monotonic() + 85.0
    return lambda: max(end - time.monotonic(), 1.0)


def _case(arch, mesh, seed, **over):
    """(mesh, reference config, port config, port params, prompts)."""
    moe_impl = over.pop("moe_impl", None)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    if moe_impl is not None:
        tcfg = dataclasses.replace(tcfg, moe_impl=moe_impl)
    jparams = jax.jit(j_steps.init_fn_for(jcfg))(jax.random.PRNGKey(seed))
    params = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    prompts = np.random.default_rng(seed).integers(
        0, jcfg.vocab, size=(4, 6)).astype(np.int32)
    return mesh, jcfg, jparams, tcfg, params, prompts


def _reference(jcfg, jparams, prompts):
    """The reference's single-device whole-batch generation, as its
    ``serve.run`` walks it: (ids (B, GEN), the top-k scores (B, TOPK) of
    each token's choice, per decode step outputs)."""
    B, S = prompts.shape
    prefill = jax.jit(j_steps.make_prefill_step(jcfg))
    decode = jax.jit(j_steps.make_decode_step(jcfg, topk=TOPK))
    pre = prefill(jparams, {"tokens": jnp.asarray(prompts)})
    caches = j_serve.pad_caches_to(
        pre["caches"], j_tf.init_lm_cache(jcfg, B, S + GEN,
                                          dtype=jnp.float32))
    scores, ids = j_io.recover_topk(jcfg, pre["last_logits"], topk=TOPK)
    token = ids[:, :1].astype(jnp.int32)
    generated, chosen, steps = [np.asarray(token)], [np.asarray(scores)], []
    for t in range(GEN - 1):
        out = decode(jparams, token, caches, jnp.int32(S + t))
        caches = out["caches"]
        token = out["topk_ids"][:, :1].astype(jnp.int32)
        generated.append(np.asarray(token))
        chosen.append(np.asarray(out["topk_scores"]))
        steps.append({k: np.asarray(out[k]) for k in
                      ("logits", "topk_ids", "topk_scores")})
    return np.concatenate(generated, 1), chosen, steps


def _check(cases, world):
    left = _deadline()
    wants = [_reference(jcfg, jparams, prompts)
             for _, jcfg, jparams, _, _, prompts in cases]
    got = t_train.spawn(t_train.run_jobs, (1, world), "gloo", "cpu", (
        [(shape, t_serve.decode_job,
          (tcfg, {n: t.numpy() for n, t in params.items()}, prompts, GEN,
           TOPK, torch.float32))
         for shape, _, _, tcfg, params, prompts in cases],),
        timeout=left())[0]
    for (shape, jcfg, *_), (ids, chosen, steps), g in zip(cases, wants,
                                                           got):
        label = f"{jcfg.name} on {shape}"
        live = np.ones(ids.shape[0], bool)     # rows fed the same tokens
        for t in range(GEN):
            # a token may differ only on a tie of the reference's scores;
            # that row's later inputs differ, so it is compared no more
            for b in np.flatnonzero(live & (g["ids"][:, t] != ids[:, t])):
                assert chosen[t][b, 0] - chosen[t][b, 1] <= 2e-5, (
                    label, "token", t, b)
                live[b] = False
            if t == GEN - 1:
                break
            s = steps[t]
            for k in ("logits", "topk_scores"):
                np.testing.assert_allclose(g[k][t][live], s[k][live],
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{label} {k} {t}")
            _same_ids(g["topk_ids"][t][live], s["topk_ids"][live],
                      s["topk_scores"][live], f"{label} step {t}")
        assert live.sum() >= ids.shape[0] - 1, label


def _same_ids(got, want, want_scores, label):
    """Top-k ids (B, topk) equal, but where the reference's score at a
    position ties with a neighbour's within 2e-5: there the two ids may
    come in the other order."""
    for b, j in zip(*np.nonzero(got != want)):
        s = want_scores[b]
        near = [abs(s[j] - s[i]) for i in (j - 1, j + 1) if 0 <= i < len(s)]
        assert min(near) <= 2e-5, (label, b, j)


def test_decode_on_two_ranks_matches_the_single_device_reference():
    """Dense 1x2 (kv heads split), GQA 1x2 with 1 kv head (replicated
    cache), MoE expert-parallel 1x2 and dense MoE 2x1, in one world of two
    ranks."""
    _check([_case("qwen3-4b", (1, 2), 0),
            _case("qwen3-4b", (1, 2), 1, num_kv_heads=1),
            _case("olmoe-1b-7b", (1, 2), 2, moe_impl="ep"),
            _case("olmoe-1b-7b", (2, 1), 3)], 2)


def test_decode_on_four_ranks_matches_the_single_device_reference():
    """Dense 2x2 (kv heads and rows split) and GQA 1x4 (2 kv heads
    replicated over a 4-way model axis), in one world of four ranks."""
    _check([_case("qwen3-4b", (2, 2), 4),
            _case("qwen3-4b", (1, 4), 5)], 4)


def test_serve_cli_on_a_mesh_prints_the_reference_runs_tokens(tmp_path):
    """``serve --static --mesh 1x2 --device cpu --ckpt DIR`` (two ranks
    started by the CLI) on the reference ``serve.run``'s weights prints
    its first sequence's tokens."""
    arch = "qwen3-4b"
    jcfg, tcfg = (jconfigs.get_smoke_config(arch),
                  tconfigs.get_smoke_config(arch))
    jparams, _ = j_serve._setup(jcfg, 0)
    want = j_serve.run(arch, batch=2, prompt_len=8, gen=GEN, topk=TOPK,
                       seed=0)
    params = t_tf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    Checkpointer(str(tmp_path)).save(0, {"params": params})
    env = subprocess_env()
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--static", "--mesh", "1x2", "--batch", "2",
         "--prompt-len", "8", "--gen", str(GEN), "--topk", str(TOPK),
         "--ckpt", str(tmp_path)], capture_output=True, text=True,
        timeout=85, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh 1x2 over gloo" in out.stdout
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("generated ids (first seq):")]
    assert eval(line[0].split(":", 1)[1]) == want[0].tolist()
