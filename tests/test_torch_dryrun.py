"""The port's dry run (``launch/dryrun.py``) against the JAX package's
shard placement, and its own invariants.

* Each of the 32 cells' per-rank ``argument_bytes`` (this rank's
  parameter, optimizer-state, batch and cache shards on the 16x16 mesh,
  the ssm, hybrid, audio and vlm families' among them: whisper's
  sequence-split self cache, long_500k's cache split over ``data``)
  equals the sum of the reference's shard shapes: one subprocess forces
  256 XLA host devices and evaluates only the reference's
  ``param_pspecs`` / ``opt_state_pspecs`` / ``batch_pspecs`` /
  ``cache_pspecs`` on its ``eval_shape`` trees, with no compile.
* The reference's L1 / L2 extrapolation of the ``reduced`` block equals
  the full-depth count exactly (smoke configs at 5 layers with the
  production attention chunks, mesh 2x2).
* ``main --all`` prints 32 ``OK`` and no ``FAIL`` on the production
  mesh and the multi-pod one, every artifact with the reference's keys
  (``test_main_all_prints_18_ok_and_14_wait`` keeps the name it had
  when 14 cells waited for ROADMAP A13b item 3).  To keep the suite
  quick, these two and the experiment twins run at a depth of one layer
  period, the encoder-decoder's encoder at one layer (the full-depth
  grid is ``python -m repro_torch.launch.dryrun --all``).
* The experiment twins run with their reference arguments; the
  execution knobs (``remat``, ``causal_skip``, ``attn_*``) change the
  count and are recorded as config, the XLA-only overrides
  (``scan_layers``, ``unroll_for_analysis``) recorded and reported;
  ZeRO-1 raises.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.experiments import (bloom_vs_dense, hillclimb,
                                     optimized_decode, optimized_grid)
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.mesh import counting_mesh
from repro_torch.models import transformer as t_tf

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a, s, ok, _ in tconfigs.all_cells() if ok]

REFERENCE_SHARDS = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.configs.base import SHAPE_BY_NAME, TrainConfig
from repro.launch import steps
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import (DistContext, batch_pspecs, cache_pspecs,
                                   opt_state_pspecs, param_pspecs)
from repro.train import trainer

mesh = make_production_mesh()
dist = DistContext(mesh)


def shard_bytes(tree, specs):
    leaves = jax.tree.leaves(tree)
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(l.shape)))
               * jnp.dtype(l.dtype).itemsize for l, s in zip(leaves, sp))


out = {}
for arch, name in json.loads(sys.argv[1]):
    cfg, shape = configs.get_config(arch), SHAPE_BY_NAME[name]
    params = jax.eval_shape(steps.init_fn_for(cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    if shape.kind != "train":
        params = jax.eval_shape(
            lambda p: steps.cast_params_for_compute(p, cfg), params)
    pspecs = param_pspecs(cfg, params, dist)
    total = shard_bytes(params, pspecs)
    if shape.kind == "train":
        opt = trainer.make_optimizer(TrainConfig(
            optimizer="adamw", grad_clip_norm=1.0, warmup_steps=0))
        state = jax.eval_shape(opt.init, params)
        total += shard_bytes(state, opt_state_pspecs(state, pspecs))
    batch = configs.input_specs(cfg, shape)
    if shape.kind == "decode":
        caches = configs.cache_specs(cfg, shape)
        total += shard_bytes(caches, cache_pspecs(cfg, caches, dist,
                                                  shape.global_batch))
        total += shard_bytes(batch["tokens"], P(
            dist.batch_spec_axes(shape.global_batch), None))
    else:
        total += shard_bytes(batch, batch_pspecs(cfg, batch, dist))
    out[f"{arch}/{name}"] = total
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_shard_bytes():
    env = subprocess_env()
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", REFERENCE_SHARDS,
                          json.dumps(CELLS)], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_the_reference_shards(arch, shape,
                                                   reference_shard_bytes):
    cfg = tconfigs.get_config(arch)
    dist = sharding.DistContext(counting_mesh())
    tc = TrainConfig(optimizer="adamw", grad_clip_norm=1.0, warmup_steps=0)
    _, arguments = dryrun.step_variant(cfg, tconfigs.SHAPE_BY_NAME[shape],
                                       dist, tc)
    assert dryrun.storage_bytes(arguments) == \
        reference_shard_bytes[f"{arch}/{shape}"]


def _cut(monkeypatch, layers=None):
    """``configs.get_config`` at a depth of ``layers`` (default: one layer
    period; the encoder-decoder one layer each), the rest of the config
    as it is."""
    full = tconfigs.get_config

    def get_config(arch, bloom=True, **over):
        cfg = full(arch, bloom=bloom, **over)
        if cfg.family == "audio":
            return dataclasses.replace(cfg, num_layers=1, encoder_layers=1)
        return dataclasses.replace(cfg, num_layers=layers
                                   or t_tf.period_of(cfg))

    monkeypatch.setattr(tconfigs, "get_config", get_config)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b"])
def test_reduced_counts_extrapolate_to_the_full_depth_count(
        arch, shape, monkeypatch):
    # the smoke widths with the production attention chunks: a few kv
    # chunks a layer, not the smoke config's 2,048 at 32,768 tokens
    smoke = tconfigs.get_smoke_config(arch, attn_chunk_q=2048,
                                      attn_chunk_k=1024)
    monkeypatch.setattr(tconfigs, "get_config", lambda a, bloom=True, **o:
                        dataclasses.replace(smoke, num_layers=5, **o))
    res = dryrun.run_cell(arch, shape, mesh_shape=(2, 2), out_dir=None)
    full = res["full"]
    assert [res["reduced"][k]["layers"] for k in ("L1", "L2")] == [1, 2]
    for key in (lambda c: c["flops_dev"], lambda c: c["bytes_dev"],
                lambda c: c["collectives"]["total_bytes"]):
        assert dryrun.extrapolate(res, key) == key(full)
    assert full["flops_dev"] > 0 and full["bytes_dev"] > 0
    assert full["collectives"]["total_bytes"] > 0
    assert res["roofline"]["flops_dev"] == full["flops_dev"]


REF_KEYS = {"arch", "shape", "mesh", "bloom", "n_devices", "param_count",
            "model_flops_global", "full"}
FULL_KEYS = {"flops_dev", "bytes_dev", "collectives", "memory",
             "compile_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_s", "roofline_fraction", "flops_dev",
                 "bytes_dev", "coll_bytes_dev", "model_flops_ratio"}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_main_all_prints_18_ok_and_14_wait(multi_pod, monkeypatch, capsys,
                                           tmp_path):
    _cut(monkeypatch)
    argv = ["--all", "--no-roofline", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as done:
        dryrun.main(argv + (["--multi-pod"] if multi_pod else []))
    assert done.value.code == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("OK ") for ln in lines) == 32
    assert not any(ln.startswith(("WAIT", "FAIL")) for ln in lines)
    assert lines[-1] == "done: 32/32 cells passed"
    tag = "multipod" if multi_pod else "singlepod"
    for arch, shape in CELLS:
        with open(tmp_path / f"{arch}__{shape}__{tag}.json") as f:
            art = json.load(f)
        assert REF_KEYS <= set(art) and FULL_KEYS <= set(art["full"])
        assert set(art["full"]["memory"]) == MEMORY_KEYS
        assert art["mesh"] == ("2x16x16" if multi_pod else "16x16")
        kernels = art["full"]["kernels"]
        want = {"train_4k": {"bloom_embed.hash.range", "bloom_csr",
                             "bloom_ce_fwd.range", "bloom_ce_bwd.range"},
                "prefill_32k": {"bloom_embed.hash.range"},
                "decode_32k": {"bloom_embed.hash.range",
                               "bloom_decode_topk"}}[
                                   "decode_32k" if shape == "long_500k"
                                   else shape]
        assert set(kernels) == want, (arch, shape)


def test_a_cell_with_its_roofline(monkeypatch, tmp_path):
    """One cell with the roofline pass: the reference's keys, the Bloom
    kernels counted by their least traffic, the MoE path recorded."""
    _cut(monkeypatch)
    res = dryrun.run_cell("olmoe-1b-7b", "decode_32k", out_dir=str(tmp_path))
    with open(res["artifact"]) as f:
        art = json.load(f)
    assert REF_KEYS | {"reduced", "roofline"} <= set(art)
    assert set(art["roofline"]) == ROOFLINE_KEYS
    assert set(art["reduced"]) == {"L1", "L2"}
    assert art["moe_impl"] == "ep" and art["xla_only_overrides"] == {}
    topk = art["full"]["kernels"]["bloom_decode_topk"]
    cfg = tconfigs.get_config("olmoe-1b-7b")
    from repro_torch.kernels import bloom_decode_topk as bdt
    assert topk == {"count": 1, "bytes": bdt.min_bytes(
        8, 8, m=cfg.m_vocab, d=cfg.vocab, k=cfg.bloom.k, topk=16)}
    r = art["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"]) > 0


def test_overrides_zero_and_op_bytes(monkeypatch, capsys):
    _cut(monkeypatch)
    res = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", out_dir=None,
                          roofline_pass=False,
                          overrides={"scan_layers": False,
                                     "unroll_for_analysis": True})
    assert res["xla_only_overrides"] == {"scan_layers": False,
                                         "unroll_for_analysis": True}
    assert "change nothing" in capsys.readouterr().out
    # the execution knobs act: recorded as config, they change the count
    base = dryrun.run_cell("qwen1.5-0.5b", "train_4k", out_dir=None,
                           roofline_pass=False)
    assert base["execution"] == {
        "remat": "full", "attn_impl": "chunked", "attn_chunk_q": 2048,
        "attn_chunk_k": 1024, "causal_skip": False,
        "attn_bf16_scores": False}
    for over in ({"causal_skip": True}, {"remat": "dots"},
                 {"remat": "none", "attn_chunk_k": 512}):
        res = dryrun.run_cell("qwen1.5-0.5b", "train_4k", out_dir=None,
                              roofline_pass=False, overrides=over)
        assert res["xla_only_overrides"] == {}
        assert over.items() <= res["execution"].items()
        assert res["full"]["flops_dev"] < base["full"]["flops_dev"], over
    assert "change nothing" not in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ZeRO-1.*A13b item 5"):
        dryrun.run_cell("qwen1.5-0.5b", "train_4k", zero=True, out_dir=None)
    x = torch.empty(4, 8, device="meta")
    aten = torch.ops.aten
    assert dryrun.op_bytes(aten.t.default, ((x,), {}), x.t()) == 0
    idx = torch.empty(3, dtype=torch.long, device="meta")
    assert dryrun.op_bytes(aten.index_select.default, ((x, 0, idx), {}),
                           x[:3]) == 3 * 8 + 2 * 3 * 8 * 4
    assert dryrun.op_bytes(aten.add.Tensor, ((x, x), {}), x + 1) == 2 * 128


def test_experiment_twins_run_with_their_reference_arguments(
        monkeypatch, capsys, tmp_path):
    _cut(monkeypatch)
    monkeypatch.chdir(tmp_path)
    bloom_vs_dense.main()
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()
            if ln.startswith("bloom=")] == ["bloom=True", "bloom=False"]
    assert "change nothing" not in out       # causal_skip acts
    for suffix in ("", "__dense"):
        with open(f"experiments/perf_torch/qwen3-4b__train_4k__cmp{suffix}"
                  ".json") as f:
            art = json.load(f)
        assert art["execution"]["causal_skip"] is True
        assert art["xla_only_overrides"] == {}
    dryrun.run_cell("qwen1.5-0.5b", "decode_32k",
                    out_dir=dryrun.OUT_DIR)
    hillclimb.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                    "--tag", "t8", "--mesh", "32x8"])
    out = capsys.readouterr().out
    assert "=== qwen1.5-0.5b decode_32k [t8]" in out
    assert "MODEL/HLO flops" in out
    optimized_decode.main()
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("OK ") for ln in out) == 12
    assert not any(ln.startswith(("WAIT", "FAIL")) for ln in out)
    assert out[-1] == "done"
    optimized_grid.main()
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("OK ") for ln in out) == 32
    assert out[-1] == "done, failures=0"
    assert os.path.isdir("experiments/dryrun_opt_torch")
