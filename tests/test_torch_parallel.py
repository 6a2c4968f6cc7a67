"""The placement rules and the vocab-parallel kernel twins, in one process.

The port's ``launch/sharding`` rules are held to the JAX package's leaf by
leaf, integer for integer: params for every arch at full width (on
``meta`` tensors) at model axes of 2, 4 and 16, the batch, decode-cache
and optimizer-state specs (with and without ZeRO-1), the 40-cell grid and
each runnable cell's input shapes and dtypes.  The reference stacks its
blocks under a leading layer axis (always unsharded); the port's
per-layer leaves have none, so each port spec is compared with the
reference's without that leading entry, and each port shape with the
reference's without that axis.  On the ``fake`` process-group backend's
world of 256 (512) ranks the production mesh builds, and every qwen3-4b
leaf's local shard has dim // prod(axes) rows on each sharded dim.

The vocab-parallel twins (the plain versions of the ranged kernels, the
CPU path): the embedding summed over 2 or 4 row ranges equals the
unsharded gather-sum within 1e-6 (the parts are summed in another order),
its ranged backwards (CSR and dense) are the unsharded ones' rows bit for
bit (each row sums the same entries in the same order); the Bloom CE with
the gathered lse equals ``bloom_ce_plain`` within 1e-6 forward and
backward.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.train import trainer as j_trainer
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import quant as t_quant
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import bloom_ce as t_ce
from repro_torch.kernels import bloom_csr as t_csr
from repro_torch.kernels import bloom_embed as t_embed
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import collectives as t_coll
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sharding
from repro_torch.launch import steps as t_steps
from repro_torch.models import io as t_io
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import trainer as t_trainer


def _ref_dist(n_model, n_data=16):
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": n_data, "model": n_model})
    return j_sharding.DistContext(mesh)


def _port_dist(n_model, n_data=16):
    return t_sharding.DistContext(t_mesh.Mesh(
        ("data", "model"), (n_data, n_model), torch.device("cpu")))


def _lookup(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as that axis (jax's
    PartitionSpec normalises ("data",) to "data")."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _unstacked(ref_spec, stacked):
    """The reference's spec without its stacked layer axis."""
    spec = _norm(ref_spec)
    if stacked is not None:
        assert spec[0] is None
        return spec[1:]
    return spec


def _meta_model(cfg):
    with torch.device("meta"):
        return t_steps.model_class_for(cfg)(cfg)


@pytest.mark.parametrize("n_model", [2, 4, 16])
@pytest.mark.parametrize("arch", list(tconfigs.ARCH_NAMES))
def test_param_specs_equal_the_reference(arch, n_model):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams = jax.eval_shape(j_steps.init_fn_for(jcfg),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    jspecs = j_sharding.param_pspecs(jcfg, jparams, _ref_dist(n_model))
    model = _meta_model(tcfg)
    specs = t_sharding.param_pspecs(tcfg, model, _port_dist(n_model))
    seen = set()
    for name, p in model.named_parameters():
        path, stacked = t_tf.reference_path(name, tcfg)
        ref = _lookup(jparams, path)
        shape = ref.shape if stacked is None else ref.shape[1:]
        assert tuple(p.shape) == tuple(shape), name
        assert tuple(specs[name]) == _unstacked(_lookup(jspecs, path),
                                                stacked), name
        seen.add((path, stacked))
    # every reference leaf (and every entry of a stacked one) is a port
    # param
    want = set()
    for kp, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        path = "/".join(str(k.key) for k in kp)
        stacked = path.startswith(("blocks/", "encoder/", "decoder/"))
        want |= ({(path, i) for i in range(leaf.shape[0])} if stacked
                 else {(path, None)})
    assert seen == want


@pytest.mark.parametrize("arch,cell", [("qwen3-4b", "decode_32k"),
                                       ("jamba-v0.1-52b", "long_500k"),
                                       ("whisper-small", "decode_32k")])
def test_batch_and_cache_specs_equal_the_reference(arch, cell):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    shape = tconfigs.SHAPE_BY_NAME[cell]
    jd, td = _ref_dist(16), _port_dist(16)
    jbatch = jconfigs.input_specs(jcfg, jconfigs.SHAPE_BY_NAME[cell])
    jb = j_sharding.batch_pspecs(jcfg, jbatch, jd)
    tb = t_sharding.batch_pspecs(tcfg, tconfigs.input_specs(tcfg, shape), td)
    assert {k: _norm(v) for k, v in tb.items()} == {
        k: _norm(v) for k, v in jb.items()}
    jcaches = jconfigs.cache_specs(jcfg, jconfigs.SHAPE_BY_NAME[cell])
    jc = j_sharding.cache_pspecs(jcfg, jcaches, jd, shape.global_batch)
    caches = tconfigs.cache_specs(tcfg, shape)
    tc = t_sharding.cache_pspecs(tcfg, caches, td, shape.global_batch)
    roles = (None if tcfg.family == "audio" else t_tf.sublayer_roles(tcfg))
    names = {"k": "k", "v": "v", "cross_k": "k", "cross_v": "v"}
    for i, (layer, specs) in enumerate(zip(caches, tc)):
        for key, leaf in layer.items():
            if roles is None:
                node = jc["cross" if key.startswith("cross") else "attn"]
                jleaf = jcaches["cross" if key.startswith("cross")
                                else "attn"][names[key]]
                jspec = node[names[key]]
            else:
                j = i % len(roles)
                mixer = "attn" if roles[j][0] == "attn" else "mamba"
                jspec = jc[f"sub{j}"][mixer][names.get(key, key)]
                jleaf = jcaches[f"sub{j}"][mixer][names.get(key, key)]
            assert tuple(leaf.shape) == tuple(jleaf.shape[1:]), (i, key)
            assert leaf.dtype == torch.bfloat16
            assert _norm(specs[key]) == _unstacked(jspec, 0), (i, key)


def _compare_state_specs(tspec, jspec, cfg, names):
    if isinstance(tspec, t_sharding.P):
        assert _norm(tspec) == _norm(jspec)
    elif isinstance(tspec, dict) and set(tspec) == names:
        for n, s in tspec.items():
            path, stacked = t_tf.reference_path(n, cfg)
            assert _norm(s) == _unstacked(_lookup(jspec, path), stacked), n
    elif isinstance(tspec, dict):
        assert set(tspec) == set(jspec)
        for k in tspec:
            _compare_state_specs(tspec[k], jspec[k], cfg, names)
    else:
        assert isinstance(tspec, tuple) and len(tspec) == len(jspec)
        for a, b in zip(tspec, jspec):
            _compare_state_specs(a, b, cfg, names)


@pytest.mark.parametrize("zero", [False, True])
def test_opt_state_specs_equal_the_reference(zero):
    """Smoke granite-8b, adamw, on a fake 16x16 mesh: every moment's spec
    (ZeRO-1 on the batch axes where asked) equals the reference's without
    the stacked axis (its 2 layers do not divide the 16 data shards, so
    the reference's ZeRO picks no layer axis here, which the port has
    not)."""
    optimizer = "adamw"
    arch = "granite-8b"
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jparams = jax.eval_shape(j_steps.init_fn_for(jcfg),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    jd, td = _ref_dist(16), _port_dist(16)
    jpspecs = j_sharding.param_pspecs(jcfg, jparams, jd)
    jstate = jax.eval_shape(j_trainer.make_optimizer(
        JTrainConfig(optimizer=optimizer)).init, jparams)
    model = _meta_model(tcfg)
    params = {n: p.detach() for n, p in model.named_parameters()}
    pspecs = t_sharding.param_pspecs(tcfg, params, td)
    state = t_trainer.make_optimizer(TrainConfig(optimizer=optimizer)
                                     ).init(params)
    if zero:
        jo = j_sharding.opt_state_pspecs(jstate, jpspecs, zero_dist=jd,
                                         params_shapes=jparams)
        to = t_sharding.opt_state_pspecs(
            state, pspecs, zero_dist=td,
            params_shapes={n: tuple(p.shape) for n, p in params.items()})
    else:
        jo = j_sharding.opt_state_pspecs(jstate, jpspecs)
        to = t_sharding.opt_state_pspecs(state, pspecs)
    _compare_state_specs(to, jo, tcfg, set(params))
    assert any("data" in _norm(s) for s in to[1]["mu"].values()) == zero


def test_cell_grid_and_input_specs_equal_the_reference():
    cells = list(tconfigs.all_cells())
    assert [(a, s, ok, r) for a, s, ok, r in cells] == list(
        jconfigs.all_cells())
    assert len(cells) == 40 and sum(ok for *_, ok, _ in cells) == 32
    for arch, cell, ok, _ in cells:
        if not ok:
            continue
        tspec = tconfigs.input_specs(tconfigs.get_config(arch),
                                     tconfigs.SHAPE_BY_NAME[cell])
        jspec = jconfigs.input_specs(jconfigs.get_config(arch),
                                     jconfigs.SHAPE_BY_NAME[cell])
        assert set(tspec) == set(jspec)
        for k, t in tspec.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(jspec[k].shape), (arch, cell, k)
            assert str(t.dtype).split(".")[1] == str(jspec[k].dtype)


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world, rank):
        tdist.init_process_group("fake", store=FakeStore(), rank=rank,
                                 world_size=world)

    yield init
    if tdist.is_initialized():
        tdist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(fake_world, multi_pod):
    world, rank = (512, 300) if multi_pod else (256, 37)
    fake_world(world, rank)
    mesh = t_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert np.prod(mesh.sizes) == world and mesh.rank == rank
    assert mesh.shape == dict(zip(*(("pod", "data", "model"), (2, 16, 16))
                                  if multi_pod else
                                  (("data", "model"), (16, 16))))
    assert np.ravel_multi_index(tuple(mesh.coords.values()),
                                mesh.sizes) == rank
    assert tdist.get_world_size(mesh.groups["model"]) == 16
    assert tdist.get_world_size(mesh.groups["batch"]) == world // 16
    dist = t_sharding.DistContext(mesh)
    assert dist.n_model == 16 and dist.n_batch == world // 16
    cfg = tconfigs.get_config("qwen3-4b")
    jcfg = jconfigs.get_config("qwen3-4b")
    jparams = jax.eval_shape(j_steps.init_fn_for(jcfg),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    jspecs = j_sharding.param_pspecs(jcfg, jparams, _ref_dist(16))
    model = _meta_model(cfg)
    specs = t_sharding.param_pspecs(cfg, model, dist)
    for name, p in model.named_parameters():
        path, stacked = t_tf.reference_path(name, cfg)
        spec = _unstacked(_lookup(jspecs, path), stacked)
        local = t_sharding.local_shard(p, specs[name], mesh)
        want = tuple(d // (16 if ax == "model" else 1)
                     for d, ax in zip(p.shape, spec))
        assert tuple(local.shape) == want, name
    # a model axis of 16 over this world, and the refusals without one
    assert t_mesh.make_elastic_mesh(world, model_parallel=16,
                                    device="cpu").shape["model"] == 16


def test_meshes_without_a_world_refuse_a_model_axis():
    for make in (lambda: t_mesh.make_elastic_mesh(8, model_parallel=2,
                                                  device="cpu"),
                 t_mesh.make_production_mesh):
        with pytest.raises(NotImplementedError, match="world"):
            make()
    with pytest.raises(RuntimeError, match="nccl needs a card per rank"):
        t_coll.init_world(0, 4, "tcp://localhost:1", "nccl", "cuda")
    with pytest.raises(ValueError, match="transport"):
        t_coll.Transport("mpi")
    assert t_mesh.make_local_mesh(device="cpu").distributed is False


def _spec(m=128, d=500, k=3):
    return BloomSpec(d=d, m=m, k=k, seed=1, on_the_fly=True)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_embedding_twins(n):
    spec, D = _spec(), 24
    g = torch.Generator().manual_seed(n)
    table = torch.randn(spec.m, D, generator=g)
    tokens = torch.randint(0, spec.d, (37,), generator=g)
    whole, idx = t_embed.bloom_embed_tokens_plain(table, None, tokens, spec)
    rows = spec.m // n
    parts = [t_embed.bloom_embed_tokens_plain(
        table[r * rows:(r + 1) * rows].contiguous(), None, tokens, spec,
        torch.float32, r * rows) for r in range(n)]
    assert all(torch.equal(i, idx) for _, i in parts)
    torch.testing.assert_close(sum(p for p, _ in parts), whole, rtol=1e-6,
                               atol=1e-6)
    # lo = 0 over every row is the unsharded gather-sum, bit for bit
    assert torch.equal(t_embed.bloom_embed_tokens_plain(
        table, None, tokens, spec, torch.float32, 0)[0], whole)
    gy = torch.randn(37, D, generator=g)
    for whole_bwd, ranged in (
            (t_csr.csr_scatter_add(gy, idx, spec.m),
             lambda lo: t_csr.csr_scatter_add(gy, idx, rows, lo)),
            (t_embed.bloom_embed_bwd_plain(gy, idx, spec.m),
             lambda lo: t_embed.bloom_embed_bwd_plain(gy, idx, rows, lo))):
        assert torch.equal(torch.cat([ranged(r * rows) for r in range(n)]),
                           whole_bwd)
    bins = t_csr.bin_csr_plain(idx, rows, rows)
    full = t_csr.bin_csr_plain(idx, spec.m)
    lo_e, hi_e = int(full.row_ptr[rows]), int(full.row_ptr[2 * rows])
    assert torch.equal(bins.row_ptr - bins.row_ptr[0],
                       full.row_ptr[rows:2 * rows + 1] - lo_e)
    assert torch.equal(bins.src[bins.row_ptr[0]:bins.row_ptr[-1]],
                       full.src[lo_e:hi_e])
    # the differentiable entry: each shard's gradient is its rows of the
    # whole table's
    for r in range(n):
        shard = table[r * rows:(r + 1) * rows].clone().requires_grad_()
        out = t_ops.bloom_embed(shard, tokens[None], spec, lo=r * rows)
        out.backward(gy[None])
        assert torch.equal(shard.grad, t_csr.csr_scatter_add(
            gy, idx, spec.m)[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_ce_twins(n):
    spec = _spec()
    g = torch.Generator().manual_seed(10 + n)
    z = torch.randn(29, spec.m, generator=g) * 3
    labels = torch.randint(0, spec.d, (29,), generator=g)
    h = spec.indices_for(labels).contiguous()
    h[0] = h[0, 0]                      # a label hashed thrice to one column
    loss, lse = t_ce.bloom_ce_plain(z, h)
    h_lab = spec.indices_for(labels).contiguous()
    rows = spec.m // n
    shards = [z[:, r * rows:(r + 1) * rows].contiguous() for r in range(n)]
    local = [t_ce.bloom_ce_shard_plain(s, h, r * rows)
             for r, s in enumerate(shards)]
    glse = torch.logsumexp(torch.stack([l for l, _ in local]), 0)
    got = glse - sum(s for _, s in local) / h.shape[1]
    torch.testing.assert_close(got, loss, rtol=1e-6, atol=1e-6)
    gy = torch.rand(29, generator=g)
    dz = t_ce.bloom_ce_bwd_plain(gy, z, h, lse)
    ranged = torch.cat([t_ce.bloom_ce_bwd_plain(gy, s, h, glse, r * rows)
                        for r, s in enumerate(shards)], dim=1)
    torch.testing.assert_close(ranged, dz, rtol=1e-6, atol=1e-6)
    # lo = 0 over the whole row: the unranged functions
    l0, s0 = t_ce.bloom_ce_shard_plain(z, h, 0)
    assert torch.equal(l0, lse)
    assert torch.equal(t_ce.bloom_ce_bwd_plain(gy, z, h, lse, 0), dz)
    # the differentiable entry (labels hashed inside) with the other
    # ranks' values supplied
    loss, lse = t_ce.bloom_ce_plain(z, h_lab)
    dz = t_ce.bloom_ce_bwd_plain(gy, z, h_lab, lse)
    local = [t_ce.bloom_ce_shard_plain(s, h_lab, r * rows)
             for r, s in enumerate(shards)]
    for r, s in enumerate(shards):
        zr = s.clone().requires_grad_()
        out = t_ops.bloom_ce_sharded(
            zr, labels, spec, r * rows,
            gather=lambda t, r=r: [t if q == r else local[q][0]
                                   for q in range(n)],
            reduce=lambda t, r=r: t + sum(local[q][1] for q in range(n)
                                          if q != r))
        torch.testing.assert_close(out, loss, rtol=1e-6, atol=1e-6)
        out.backward(gy)
        torch.testing.assert_close(zr.grad, dz[:, r * rows:(r + 1) * rows],
                                   rtol=1e-6, atol=1e-6)


def test_global_norm_counts_each_leaf_once():
    """Two model ranks, each holding half of a split leaf and all of a
    replicated one: the norm each computes is the whole tree's."""
    g = torch.Generator().manual_seed(0)
    split, rep = torch.randn(8, 6, generator=g), torch.randn(5, generator=g)
    halves = split.chunk(2)
    whole = t_opt.global_norm({"w": split, "b": rep})
    sq = [torch.sum(h ** 2) for h in halves]
    for r in range(2):
        got = t_opt.global_norm({"w": halves[r], "b": rep}, {"w"},
                                lambda t, r=r: t + sq[1 - r])
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=0)


def test_what_the_parallel_step_refuses():
    """Under a model axis only a decode step called without its caches'
    specs (``sharding.decode_dist``) raises; a quantized table runs: one
    rank's int8 part of the embedding is the ranged gather-sum of its own
    quantized rows, bit for bit, all-reduced over ``model`` once (the
    counting mesh records the call).  Decode of a cache whose sequence splits
    (over ``model``, where neither the heads nor the kv heads divide the
    axis; over the batch axes, where the batch does not divide them) and
    the mamba / hybrid / audio / vlm families' tensor parallelism build
    and run (tests/test_torch_parallel_families_gloo.py)."""
    dist = _port_dist(2, 1)
    cfg = tconfigs.get_smoke_config("qwen3-4b")
    t_steps.make_decode_step(cfg, 4, "cpu", dist)
    t_steps.make_decode_step(cfg, 4, "cpu", _port_dist(8, 1))
    for arch in ("mamba2-1.3b", "jamba-v0.1-52b", "whisper-small",
                 "pixtral-12b"):
        acfg = tconfigs.get_smoke_config(arch)
        t_steps.make_train_step(acfg, TrainConfig(), dist)
        t_steps.make_prefill_step(acfg, dist)
        step = t_steps.make_decode_step(acfg, 4, "cpu", dist)
        with pytest.raises(ValueError, match="decode_dist"):
            step(None, torch.zeros(2, 1, dtype=torch.long), [], 3)
    qcfg = dataclasses.replace(cfg, table_dtype="int8")
    cdist = t_sharding.DistContext(t_mesh.counting_mesh((2, 2)))
    g = torch.Generator().manual_seed(3)
    shard = torch.randn(cfg.m_vocab // 2, cfg.d_model, generator=g)
    tokens = torch.randint(0, cfg.vocab, (1, 5), generator=g)
    got = t_io.embed_tokens(shard, qcfg, tokens, cdist)
    q, scales = t_quant.quantize_table(shard, "int8")
    want = t_embed.bloom_embed_tokens_plain(
        q, scales, tokens.reshape(-1), t_io.vocab_spec(qcfg),
        getattr(torch, cfg.dtype), 0)[0]
    assert torch.equal(got.reshape(want.shape), want)
    assert [c["kind"] for c in cdist.mesh.transport.calls] == ["all-reduce"]


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "whisper-small",
                                  "pixtral-12b"])
def test_a_one_rank_mesh_runs_every_family_as_one_process(arch):
    """With a model axis of 1 every family runs the parallel step; on a
    one-rank mesh it is the one-process step bit for bit (two steps)."""
    cfg = tconfigs.get_smoke_config(arch)
    tc = TrainConfig(optimizer="adamw", warmup_steps=0)
    dist = t_sharding.DistContext(t_mesh.make_local_mesh(device="cpu"))
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=g)}
    if cfg.family in ("vlm", "audio"):
        batch["embeds"] = torch.randn(2, 4, cfg.d_model, generator=g)
    runs = []
    for d in (None, dist):
        model = t_steps.init_fn_for(cfg)(0)
        step, opt = t_steps.make_train_step(cfg, tc, d)
        state = opt.init({n: p.detach() for n, p in model.named_parameters()})
        losses = []
        for _ in range(2):
            state, m = step(model, state, batch)
            losses.append(float(m["loss"]))
        runs.append((losses, dict(model.named_parameters())))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n
