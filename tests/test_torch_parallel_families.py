"""Tensor parallelism for the ssm, hybrid, audio and vlm families, in one
process (no world).

* The port's ``param_pspecs`` and ``cache_pspecs`` equal the JAX
  package's, leaf by leaf, for the four families' smoke configs on a
  (2, n) mesh at model axes n = 2, 3 and 4, for decode caches of a batch
  of 4 (rows split over ``data``) and of 1 (the sequence split over
  ``data``, and over ``model`` where neither the heads nor the kv heads
  divide it); the split that the gloo tests decode through is checked
  to happen, and ``seq_shard`` to give each rank the positions
  ``local_shard`` cuts.
* ``collectives.merge_softmax`` of the partials of n slices of the keys
  (``attention._attend_partial``) equals unsplit attention within 1e-6,
  with a slice in which no key is valid (its max is -inf: weighed 0, no
  NaN).
* The chunked SSD's gradient stays finite at a full chunk (256) whose
  intra-chunk decay overflows above the diagonal (the reference's
  ``where(causal, exp(decay), 0)`` gives 0 * inf there), and its forward
  is the masked-after-exp one's bit for bit.
* The Mamba mixer's gated RMSNorm over channels split n ways, each
  rank's sum of squares all-reduced both ways (``all_reduce_model``),
  equals the whole norm within 1e-6, forward and gradient: n threads
  stand in for the ranks, exchanging through an in-process transport.
"""
import threading
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import collectives as t_coll
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sharding
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import mamba2 as t_mamba
from repro_torch.models import transformer as t_tf

FAMILIES = ["mamba2-1.3b", "jamba-v0.1-52b", "whisper-small", "pixtral-12b"]


def _norm(spec) -> tuple:
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _unstacked(ref_spec, stacked):
    spec = _norm(ref_spec)
    if stacked is not None:
        assert spec[0] is None
        return spec[1:]
    return spec


def _lookup(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _dists(n_model, n_data=2, rank=0):
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": n_data, "model": n_model})
    port = t_mesh.Mesh(("data", "model"), (n_data, n_model),
                       torch.device("cpu"), rank)
    return j_sharding.DistContext(mesh), t_sharding.DistContext(port)


@pytest.mark.parametrize("n_model", [2, 3, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_specs_equal_the_reference(arch, n_model):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jd, td = _dists(n_model)
    jparams = jax.eval_shape(j_steps.init_fn_for(jcfg),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    jspecs = j_sharding.param_pspecs(jcfg, jparams, jd)
    with torch.device("meta"):
        model = t_steps.model_class_for(tcfg)(tcfg)
    specs = t_sharding.param_pspecs(tcfg, model, td)
    for name, p in model.named_parameters():
        path, stacked = t_tf.reference_path(name, tcfg)
        assert tuple(specs[name]) == _unstacked(_lookup(jspecs, path),
                                                stacked), name
    roles = None if tcfg.family == "audio" else t_tf.sublayer_roles(tcfg)
    names = {"k": "k", "v": "v", "cross_k": "k", "cross_v": "v"}
    for B in (4, 1):
        shape = ShapeConfig("t", 12, B, "decode")
        jcaches = jconfigs.cache_specs(jcfg, JShapeConfig("t", 12, B,
                                                          "decode"))
        jc = j_sharding.cache_pspecs(jcfg, jcaches, jd, B)
        caches = tconfigs.cache_specs(tcfg, shape)
        tc = t_sharding.cache_pspecs(tcfg, caches, td, B)
        for i, (layer, lspecs) in enumerate(zip(caches, tc)):
            for key in layer:
                if roles is None:
                    part = "cross" if key.startswith("cross") else "attn"
                    jspec = jc[part][names[key]]
                else:
                    j = i % len(roles)
                    mixer = "attn" if roles[j][0] == "attn" else "mamba"
                    jspec = jc[f"sub{j}"][mixer][names.get(key, key)]
                assert _norm(lspecs[key]) == _unstacked(jspec, 0), (
                    B, i, key)


def test_the_splits_the_gloo_tests_decode_through():
    """whisper-small smoke (4 heads) on 1x3 with 12 self positions and 6
    frames: both caches split their sequence over ``model``; pixtral-12b
    smoke with B = 1 on 2x1: over ``data``; every rank's ``seq_shard``
    names the slice ``local_shard`` cuts."""
    cases = [("whisper-small", (1, 3), 4, 12, 6, "model"),
             ("pixtral-12b", (2, 1), 1, 16, 0, "data")]
    for arch, (nd, nm), B, T, frames, axis in cases:
        cfg = tconfigs.get_smoke_config(arch)
        if cfg.family == "audio":
            from repro_torch.models import encdec
            whole = encdec.init_encdec_cache(cfg, B, T, frames,
                                             device="meta")
        else:
            whole = t_tf.init_lm_cache(cfg, B, T, device="meta")
        for rank in range(nd * nm):
            d = t_sharding.DistContext(t_mesh.Mesh(
                ("data", "model"), (nd, nm), torch.device("cpu"), rank,
                {"data": "data", "model": "model", "batch": "data"}))
            d = t_sharding.decode_dist(cfg, whole, d, B)
            n = nd * nm
            for key in [k for k in whole[0] if k in ("k", "cross_k")]:
                spec = d.cache_specs[0][key]
                assert spec[1] == axis, (arch, key, spec)
                full = torch.arange(whole[0][key].shape[1]).reshape(
                    1, -1, 1, 1).expand(B, -1, 1, 1)
                cut = t_sharding.local_shard(full, (spec[0], spec[1], None,
                                                    None), d.mesh)
                seq = d.seq_shard(0, key)
                lo = seq.index * cut.shape[1]
                assert cut[0, :, 0, 0].tolist() == list(
                    range(lo, lo + cut.shape[1]))
                assert seq.group == axis
                assert cut.shape[1] * n == whole[0][key].shape[1]


def test_merged_softmax_slices_equal_unsplit_attention():
    """q (B, 1, H, hd) over T keys of KV < H heads (GQA), the keys cut
    into n slices; one slice holds no valid key for some rows."""
    g = torch.Generator().manual_seed(0)
    B, H, KV, hd, T = 3, 4, 2, 8, 12
    q = torch.randn(B, 1, H, hd, generator=g)
    k = torch.randn(B, T, KV, hd, generator=g)
    v = torch.randn(B, T, KV, hd, generator=g)
    pos = torch.tensor([2, 7, 11])              # row 0 sees 3 keys
    valid = torch.arange(T)[None, None, :] <= pos[:, None, None]
    want = t_attn._attend(q, k, v, valid)
    for n in (2, 3, 4):
        w = T // n
        parts = [t_attn._attend_partial(q, k[:, i * w:(i + 1) * w],
                                        v[:, i * w:(i + 1) * w],
                                        valid[..., i * w:(i + 1) * w])
                 for i in range(n)]
        m, l, o = (torch.stack(x) for x in zip(*parts))
        assert torch.isinf(m[-1, 0]).all() and (l[-1, 0] == 0).all()
        got = t_coll.merge_softmax(m, l, o)
        assert not torch.isnan(got).any()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        # unmasked (the cross attention): every slice valid
        parts = [t_attn._attend_partial(q, k[:, i * w:(i + 1) * w],
                                        v[:, i * w:(i + 1) * w], None)
                 for i in range(n)]
        m, l, o = (torch.stack(x) for x in zip(*parts))
        torch.testing.assert_close(t_coll.merge_softmax(m, l, o),
                                   t_attn._attend(q, k, v, None),
                                   rtol=0, atol=1e-6)


class _Threads:
    """n ranks as threads of this process: ``all_reduce`` sums every
    thread's tensor, in rank order, into each."""

    def __init__(self, n):
        self.n, self.parts = n, [None] * n
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    def all_reduce(self, t, group):
        self.parts[self.local.rank] = t.clone()
        self.barrier.wait()
        total = sum(self.parts[1:], self.parts[0].clone())
        self.barrier.wait()
        t.copy_(total)
        return t


@pytest.mark.parametrize("n", [2, 4])
def test_gated_norm_over_split_channels_with_its_gradient(n):
    cfg = tconfigs.get_smoke_config("mamba2-1.3b")
    d_in = cfg.mamba.expand * cfg.d_model
    g = torch.Generator().manual_seed(n)
    y = torch.randn(2, 3, d_in, generator=g)
    z = torch.randn(2, 3, d_in, generator=g)
    w = torch.randn(2, 3, d_in, generator=g)
    scale = 1.0 + 0.1 * torch.randn(d_in, generator=g)

    def run(y, z, scale, w, tp):
        y, z, scale = (t.clone().requires_grad_(True) for t in (y, z, scale))
        p = types.SimpleNamespace(norm=scale)
        out = t_mamba._gated_norm(p, cfg, y, z, tp)
        (out * w).sum().backward()
        return out.detach(), y.grad, z.grad, scale.grad

    want = run(y, z, scale, w, None)
    tr, c = _Threads(n), d_in // n
    got = [None] * n

    def rank(r):
        tr.local.rank = r
        mesh = t_mesh.Mesh(("data", "model"), (1, n), torch.device("cpu"),
                           r, {"model": None}, tr)
        cut = slice(r * c, (r + 1) * c)
        got[r] = run(y[..., cut], z[..., cut], scale[cut], w[..., cut],
                     t_sharding.DistContext(mesh))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, what in enumerate(("out", "dy", "dz", "dscale")):
        torch.testing.assert_close(torch.cat([x[i] for x in got], -1),
                                   want[i], rtol=0, atol=1e-6, msg=what)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """mamba2 smoke widths at a chunk of 256, fast decays (A up to 16, dt
    near 1): cs_i - cs_j above the diagonal reaches ~4,000, far past
    f32's exp range."""
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 1, 256, 4, 8, 8
    x = torch.randn(B, S, H, P, generator=g, requires_grad=True)
    dt = (0.5 + 0.5 * torch.rand(B, S, H, generator=g)).requires_grad_(True)
    A = -torch.linspace(1.0, 16.0, H).requires_grad_(True)
    Bm = torch.randn(B, S, 1, N, generator=g, requires_grad=True)
    Cm = torch.randn(B, S, 1, N, generator=g, requires_grad=True)
    y, h = t_mamba._ssd_chunked(x, dt, A, Bm, Cm, 256)
    (y.sum() + h.sum()).backward()
    for t in (x, dt, Bm, Cm):
        assert torch.isfinite(t.grad).all()
    # the forward the reference's order gives: exp first, then the mask
    cs = torch.cumsum(dt * A, dim=1)
    decay = cs[:, :, None, :] - cs[:, None, :, :]
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool))
    with torch.no_grad():
        L_ref = torch.where(causal[None, :, :, None], torch.exp(decay), 0.0)
        L = torch.exp(torch.where(causal[None, :, :, None], decay,
                                  -float("inf")))
    assert torch.isinf(torch.exp(decay)).any()
    assert torch.equal(L, L_ref)
