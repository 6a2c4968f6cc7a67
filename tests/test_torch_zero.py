"""ZeRO-1 execution (``steps.make_train_step(zero=True)``), and an int8 Bloom
table under a model axis, over real ranks: four CPU processes over gloo,
started once by ``launch/train.spawn`` for the module.

* ZeRO-1 on mesh 2x2: each Adam moment holds this rank's slice over the
  data axis (half of each split leaf's bytes, exactly), the update runs
  on the slices and each slice is all-gathered into its param; after 3
  steps the params, gathered whole on rank 0, equal the same mesh's
  plain run bit for bit (same weights, same batches): the clip's norm is
  the whole gradients', and every other transform of adamw is
  elementwise.
* A ZeRO-1 checkpoint (2 steps on 2x2) holds the moments whole, in the
  reference's npz + JSON format; resumed on mesh 1x4 without ZeRO-1, the
  next loss equals the one-process straight run's within rtol 1e-6
  (``tests/test_checkpoint.py``'s tolerance for resumed training).
* An int8 table on mesh 2x2 (each rank quantizes its own vocab rows):
  the losses within rtol 1e-5 of one process's run from the same
  weights (the ranks sum the embedding's parts, the row-parallel
  products and the loss's hit sums in another order).  That one-process
  run is held to the reference's ``io_impl="pallas"`` trajectory by
  tests/test_torch_train.py.

The spawn is bounded by the time left of 85 s (``spawn``'s ``timeout``).
In one process: ZeRO-1's placement helpers, and the dry run's count of a
ZeRO-1 step (its argument bytes exactly what the moments' slices
predict, its collective term larger by the update's all-gathers)."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf

ARCH = "qwen1.5-0.5b"
TC = dict(optimizer="adamw", learning_rate=3e-3, grad_clip_norm=1.0,
          warmup_steps=0, weight_decay=0.1)
RUN = dict(batch=4, seq=16, log_every=1, device="cpu", learning_rate=3e-3)


def _moments(state):
    """name -> the bytes of each Adam moment leaf (mu and nu) of a
    state."""
    out = {}

    def walk(st):
        if isinstance(st, dict) and "mu" in st and "nu" in st:
            for key in ("mu", "nu"):
                for n, t in st[key].items():
                    out[f"{key}/{n}"] = t.numel() * t.element_size()
        elif isinstance(st, dict):
            for v in st.values():
                walk(v)
        elif isinstance(st, (tuple, list)):
            for v in st:
                walk(v)

    walk(state)
    return out


def zero_job(mesh, cfg, qcfg, tc, params, batches, kw):
    """One rank's runs from the same weights and batches: plain and
    ZeRO-1 on this 2x2 mesh (rank 0: both runs' params gathered whole;
    every rank: its moments' bytes and ZeRO-1's split dims), int8 on
    2x2 (the losses), then a ZeRO-1 run of 2 steps with a checkpoint
    (``train._train``) resumed on a 1x4 mesh of the same ranks without
    ZeRO-1 to step 3 (its history)."""
    dist_ctx = sharding.DistContext(mesh)
    full = {n: torch.as_tensor(v) for n, v in params.items()}
    out = {}
    for label, c, zero in (("plain", cfg, False), ("zero", cfg, True),
                           ("int8", qcfg, False)):
        step, optimizer = steps_lib.make_train_step(c, tc, dist_ctx, zero)
        model, opt_state, _, _, specs, _ = t_train.parallel_state(
            c, optimizer, 0, None, dist_ctx, full, zero)
        losses = []
        for b in batches:
            opt_state, m = step(model, opt_state,
                                {k: torch.as_tensor(v)
                                 for k, v in b.items()})
            losses.append(float(m["loss"]))
        whole = sharding.gather_state_dict(
            dict(model.named_parameters()), specs, mesh)
        out[label] = {"losses": losses, "moments": _moments(opt_state)}
        if zero:
            out[label]["dims"] = steps_lib.zero_specs(c, optimizer, model,
                                                      dist_ctx)
        if mesh.rank == 0 and label != "int8":
            out[label]["params"] = {n: t.numpy() for n, t in whole.items()}
    t_train._train(dist_ctx=dist_ctx, device=mesh.device, zero=True,
                   **dict(kw, steps=2))
    wide = mesh_lib.world_mesh((1, 4), mesh.axis_names, mesh.device,
                               mesh.transport)
    out["resumed"] = t_train._train(
        dist_ctx=sharding.DistContext(wide), device=mesh.device,
        **dict(kw, steps=3))[1]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (``zero_job``) and the one-process runs
    they are held to."""
    end = time.monotonic() + 85.0
    cfg = tconfigs.get_smoke_config(ARCH)
    qcfg = dataclasses.replace(cfg, table_dtype="int8")
    params = {n: p.detach().numpy() for n, p in
              steps_lib.init_fn_for(cfg)(0).named_parameters()}
    rng = np.random.default_rng(31)
    batches = [{"tokens": rng.integers(0, cfg.vocab, size=(8, 17))
                .astype(np.int32)} for _ in range(3)]
    ckpt = str(tmp_path_factory.mktemp("zero_ckpt"))
    kw = dict(arch=ARCH, ckpt_dir=ckpt, full=False, bloom=True,
              microbatch=0, grad_compression="none", seed=0, fault_at=-1,
              bwd_impl=None, table_dtype=None, failpoints=None,
              moe_impl=None, **{k: v for k, v in RUN.items()
                                if k != "device"})
    outs = t_train.spawn(zero_job, (2, 2), "gloo", "cpu", (
        cfg, qcfg, TrainConfig(**TC), params, batches, kw),
        timeout=max(end - time.monotonic(), 1.0))
    # one process: the int8 run from the same weights and batches, and
    # the straight 3-step run the resume is held to
    model = steps_lib.init_fn_for(qcfg)(0)
    step, opt = steps_lib.make_train_step(qcfg, TrainConfig(**TC))
    state = opt.init({n: p.detach() for n, p in model.named_parameters()})
    int8 = []
    for b in batches:
        state, m = step(model, state, {"tokens": torch.as_tensor(
            b["tokens"])})
        int8.append(float(m["loss"]))
    straight = t_train.run(ARCH, steps=3, **RUN)[1]
    return {"outs": outs, "int8": int8, "straight": straight}


def test_zero_params_equal_the_plain_steps_bit_for_bit(ranks):
    """After 3 steps on 2x2 the ZeRO-1 run's params, gathered whole on
    rank 0, equal the plain run's (``np.array_equal``), and its losses
    equal the plain run's on every rank."""
    outs = ranks["outs"]
    plain, zero = outs[0]["plain"]["params"], outs[0]["zero"]["params"]
    assert set(plain) == set(zero)
    for n in plain:
        assert np.array_equal(plain[n], zero[n]), n
    for r, out in enumerate(outs):
        assert out["zero"]["losses"] == out["plain"]["losses"], r
        assert out["zero"]["losses"] == outs[0]["zero"]["losses"]


def test_each_split_moment_holds_half_its_bytes(ranks):
    """Every rank's Adam moments under ZeRO-1 on 2 data ranks: a split
    leaf (``zero_specs``' keys, most of the model's leaves) holds exactly
    1/2 of the plain run's bytes, every other leaf all of them."""
    for out in ranks["outs"]:
        dims = out["zero"]["dims"]
        plain, zero = out["plain"]["moments"], out["zero"]["moments"]
        assert set(plain) == set(zero) and len(dims) >= len(plain) // 4
        for key, nbytes in plain.items():
            split = key.split("/", 1)[1] in dims
            assert zero[key] * (2 if split else 1) == nbytes, key
        assert sum(zero.values()) < 0.6 * sum(plain.values())


def test_a_zero_checkpoint_resumes_on_1x4_without_zero(ranks):
    """The ZeRO-1 run's checkpoint at step 2 (moments gathered whole),
    resumed on 1x4 without ZeRO-1: the step-3 loss equals the straight
    one-process run's within rtol 1e-6, on every rank."""
    want = ranks["straight"]
    assert [h["step"] for h in want] == [1, 2, 3]
    for out in ranks["outs"]:
        got = out["resumed"]
        assert [h["step"] for h in got] == [3]
        assert got[0]["loss"] == pytest.approx(want[2]["loss"], rel=1e-6)


def test_int8_on_2x2_equals_one_process(ranks):
    """An int8 table on mesh 2x2 (each rank's quantized rows through the
    ranged gather-sum, its part all-reduced): the losses within rtol
    1e-5 of one process's int8 run from the same weights and batches."""
    for out in ranks["outs"]:
        np.testing.assert_allclose(out["int8"]["losses"], ranks["int8"],
                                   rtol=1e-5)


def _meshes():
    """One counting mesh of (pod, data, model) = (2, 2, 2) per rank."""
    base = mesh_lib.counting_mesh((2, 2, 2))
    return [dataclasses.replace(base, rank=r) for r in range(8)]


def test_a_zero_moment_shards_over_a_tuple_of_batch_axes():
    """On a (pod, data, model) mesh the ZeRO-1 specs name both batch
    axes on one dim (``opt_state_pspecs``): the dim ``zero_dim`` picks,
    the same from a rank's shard as from the full leaf, and the entry
    ``zero_spec`` writes; the eight ranks' ``local_shard`` of a moment,
    laid out by (batch index, model index), are the whole moment."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = steps_lib.init_fn_for(cfg)(0)
    meshes = _meshes()
    dist = sharding.DistContext(meshes[0])
    specs = sharding.param_pspecs(cfg, model, dist)
    full = {n: p.detach() for n, p in model.named_parameters()}
    _, opt = steps_lib.make_train_step(cfg, TrainConfig(**TC), dist, True)
    state = opt.init(full)
    zspecs = sharding.opt_state_pspecs(state, specs, zero_dist=dist,
                                       params_shapes={n: tuple(t.shape)
                                                      for n, t in
                                                      full.items()})
    dims = {n: sharding.zero_dim(specs[n], t.shape, dist.n_batch)
            for n, t in full.items()}
    dims = {n: d for n, d in dims.items() if d is not None}
    assert dims
    for n, d in dims.items():
        local = sharding.local_shard(full[n], specs[n], meshes[0])
        assert sharding.zero_dim(specs[n], local.shape, dist.n_batch) == d
    mu = next(s for s in state if isinstance(s, dict) and "mu" in s)["mu"]
    for n, d in dims.items():
        spec = zspecs[[i for i, s in enumerate(state)
                       if isinstance(s, dict) and "mu" in s][0]]["mu"][n]
        assert spec[d] == ("pod", "data")
        assert spec == sharding.zero_spec(specs[n], d, dist)
        moment = torch.randn(mu[n].shape)
        parts = {}
        for m in meshes:
            c = m.coords
            parts[(c["pod"] * 2 + c["data"], c["model"])] = \
                sharding.local_shard(moment, spec, m)
        model_dims = [i for i, e in enumerate(spec) if e == "model"]
        rows = []
        for b in range(4):
            row = [parts[(b, j)] for j in range(2)]
            rows.append(torch.cat(row, model_dims[0]) if model_dims
                        else row[0])
        assert torch.equal(torch.cat(rows, d), moment), n


def test_zero_needs_a_mesh_and_a_data_axis():
    """``zero=True`` without a mesh raises; on a mesh whose batch axes
    are 1 nothing splits (the plain step), nor under adafactor, whose
    factored moments stay whole."""
    cfg = tconfigs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="ZeRO-1"):
        steps_lib.make_train_step(cfg, TrainConfig(**TC), None, zero=True)
    with pytest.raises(ValueError, match="ZeRO-1"):
        t_train.run(ARCH, steps=1, zero=True, **RUN)
    model = steps_lib.init_fn_for(cfg)(0)
    for shape, name, splits in (((1, 2), "adamw", False),
                                ((2, 2), "adamw", True),
                                ((2, 2), "adafactor", False)):
        dist = sharding.DistContext(mesh_lib.counting_mesh(shape))
        tc = TrainConfig(**dict(TC, optimizer=name))
        _, opt = steps_lib.make_train_step(cfg, tc, dist, True)
        assert bool(steps_lib.zero_specs(cfg, opt, model, dist)) == splits


def _cut(monkeypatch):
    full = tconfigs.get_config

    def get_config(arch, bloom=True, **over):
        cfg = full(arch, bloom=bloom, **over)
        return dataclasses.replace(cfg, num_layers=t_tf.period_of(cfg))

    monkeypatch.setattr(tconfigs, "get_config", get_config)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_the_dry_run_counts_zero_moments_and_all_gathers(arch,
                                                         monkeypatch):
    """``run_cell(zero=True)`` at a depth of one layer period on 16x16:
    its argument bytes are the plain count's less (1 - 1/16) of each
    split moment's bytes, exactly (``zero_specs`` on the same rank's
    ``meta`` shards), and its collective term is larger, by the update's
    all-gathers over the 16 data ranks (one a split param)."""
    _cut(monkeypatch)
    plain = dryrun.run_cell(arch, "train_4k", out_dir=None,
                            roofline_pass=False)
    zero = dryrun.run_cell(arch, "train_4k", out_dir=None,
                           roofline_pass=False, zero=True)
    cfg = tconfigs.get_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    dist = sharding.DistContext(mesh_lib.counting_mesh())
    model = dryrun._meta_model(cfg, dist, serving=False)
    _, opt = steps_lib.make_train_step(cfg, TrainConfig(**TC), dist, True)
    dims = steps_lib.zero_specs(cfg, opt, model, dist)
    assert dims
    params = dict(model.named_parameters())
    saved = sum(2 * params[n].numel() * 4 * 15 // 16 for n in dims)
    assert (zero["full"]["memory"]["argument_bytes"]
            == plain["full"]["memory"]["argument_bytes"] - saved)
    pc, zc = plain["full"]["collectives"], zero["full"]["collectives"]
    assert zc["total_bytes"] > pc["total_bytes"]
    gathered = sum(params[n].numel() * 4 for n in dims)
    assert zc["total_bytes"] - pc["total_bytes"] == pytest.approx(
        gathered * 15 / 16, rel=1e-9)


def test_hillclimb_zero_counts_against_its_baseline(monkeypatch, tmp_path,
                                                    capsys):
    """``experiments.hillclimb --zero`` (the reference's flag) counts the
    cell with ZeRO-1 and prints its deltas against the plain artifact;
    its own artifact says ``zero`` and holds fewer argument bytes."""
    import json
    from repro_torch.experiments import hillclimb
    _cut(monkeypatch)
    base = dryrun.run_cell(ARCH, "train_4k", out_dir=str(tmp_path / "base"))
    hillclimb.main(["--arch", ARCH, "--shape", "train_4k", "--tag", "zero",
                    "--zero", "--out", str(tmp_path / "perf"),
                    "--baseline", base["artifact"]])
    out = capsys.readouterr().out
    assert f"=== {ARCH} train_4k [zero]" in out and "collective_s" in out
    with open(tmp_path / "perf" / f"{ARCH}__train_4k__zero.json") as f:
        art = json.load(f)
    assert art["zero"] and not base["zero"]
    assert (art["full"]["memory"]["argument_bytes"]
            < base["full"]["memory"]["argument_bytes"])
    assert art["roofline"]["collective_s"] > base["roofline"]["collective_s"]
