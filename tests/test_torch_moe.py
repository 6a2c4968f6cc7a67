"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the reference's params, with inputs
drawn from a numpy seed, f32.

Checked: the routing integers exactly — the top-k expert ids, each routed
copy's queue position, which copies are kept and their buffer slots —
against the reference's own routing lines (``_route_local`` with every
expert local), with drops (capacity factor 1.0 and 0.25) and on ties (a
zero router: every probability equal, so the lowest ids win); the gates
and the load-balance aux within 1e-6; the capacity path's output and aux
against the reference's within 1e-5 (the six cases of
tests/test_models_moe.py, each on shared params); the dense oracle
against the reference's oracle; the gradients against ``jax.grad``
within 1e-4; and the capacity arithmetic at the serving shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as j_moe
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoEConfig, ModelConfig
from repro_torch.models import moe as t_moe

KEY = jax.random.PRNGKey(0)
# the reference's functions jitted (cfg static): many times faster on the
# CPU than op by op
J_APPLY = jax.jit(j_moe.moe_apply, static_argnums=(2,))
J_ORACLE = jax.jit(j_moe.moe_apply_reference, static_argnums=(2,))


def _cfgs(E=8, k=2, shared=0, cf=8.0):
    kw = dict(name="moe", family="moe", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=2, d_ff=32, vocab=64,
              dtype="float32")
    mkw = dict(num_experts=E, top_k=k, num_shared=shared, d_ff_expert=24,
               capacity_factor=cf)
    return (JModelConfig(moe=JMoEConfig(**mkw), **kw),
            ModelConfig(moe=MoEConfig(**mkw), **kw))


def _pair(E=8, k=2, shared=0, cf=8.0, seed=0):
    """(jcfg, tcfg, reference params, the port's MoE on the same
    numbers)."""
    jcfg, tcfg = _cfgs(E, k, shared, cf)
    jp = j_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tm = t_moe.MoE(tcfg)
    tm.load_state_dict(_state(jp))
    return jcfg, tcfg, jp, tm


def _state(jp):
    sd = {}
    for name, a in jp.items():
        if isinstance(a, dict):
            for sub, b in a.items():
                sd[f"{name}.{sub}"] = torch.from_numpy(np.array(b))
        else:
            sd[name] = torch.from_numpy(np.array(a))
    return sd


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _reference_routing(params, x_flat, cfg, C):
    """The routing lines of the reference's ``_route_local`` (expert_offset
    0, num_local E), returning the integers it keeps internal."""
    mo = cfg.moe
    T = x_flat.shape[0]
    k, E = mo.top_k, mo.num_experts
    logits = (x_flat @ params["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, sel = jax.lax.top_k(probs, k)
    gate = gate / jnp.clip(gate.sum(-1, keepdims=True), 1e-9, None)
    f = jnp.zeros((E,), jnp.float32).at[sel.reshape(-1)].add(1.0) / (T * k)
    aux = mo.num_experts * jnp.sum(f * probs.mean(0))
    flat_sel = sel.reshape(-1)
    oh = jax.nn.one_hot(flat_sel, E, dtype=jnp.int32)
    pos = jnp.cumsum(oh, axis=0) - oh
    pos_sel = (pos * oh).sum(-1)
    keep = pos_sel < C
    slot = jnp.where(keep, flat_sel * C + pos_sel, E * C)
    return dict(sel=sel, gate=gate, pos=pos_sel, keep=keep, slot=slot,
                aux=aux)


@pytest.mark.parametrize("E,k,cf,T,zero_router", [
    (8, 2, 8.0, 20, False),      # no drops
    (8, 2, 1.0, 40, False),      # drops at capacity factor 1.0
    (8, 3, 0.25, 32, False),     # most copies dropped
    (64, 6, 1.25, 4, False),     # deepseek's decode shape: C = 1
    (8, 2, 1.0, 24, True),       # ties: every probability equal
])
def test_routing_integers_equal_the_reference(E, k, cf, T, zero_router):
    jcfg, tcfg, jp, tm = _pair(E=E, k=k, cf=cf)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
        with torch.no_grad():
            tm.router.zero_()
    x = _x((T, 16))
    C = j_moe._capacity(T, jcfg)
    assert t_moe.capacity(T, tcfg) == C
    want = jax.jit(_reference_routing, static_argnums=(2, 3))(
        jp, jnp.asarray(x), jcfg, C)
    with torch.no_grad():
        got = t_moe.route(tm.router, torch.from_numpy(x), tcfg, C)
    for name in ("sel", "pos", "keep", "slot"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(want[name]),
            err_msg=name)
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want["gate"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.aux), float(want["aux"]), rtol=0,
                               atol=1e-6)
    if zero_router:
        # every token picks experts 0..k-1, the lowest ids
        assert (got.sel.numpy() == np.arange(k)).all()
    if cf <= 1.0:
        assert not got.keep.all()        # the case has drops


def _apply_both(jcfg, tcfg, jp, tm, x):
    want, jaux = J_APPLY(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = t_moe.moe_apply(tm, torch.from_numpy(x), tcfg)
    return got.numpy(), float(aux), np.asarray(want), float(jaux)


@pytest.mark.parametrize("case", [
    "no_drops", "shared", "dropping", "top1", "deepseek_decode"])
def test_moe_apply_matches_the_reference(case):
    """The capacity path: output within 1e-5 and aux within 1e-5 of the
    reference's on the same params and input (tests/test_models_moe.py's
    no-drop, shared-expert and dropping cases, top-1, and a C = 1 decode
    batch over 64 experts top-6 with 2 shared)."""
    kw, shape = {
        "no_drops": (dict(cf=16.0), (2, 10, 16)),
        "shared": (dict(shared=2, cf=16.0), (1, 6, 16)),
        "dropping": (dict(cf=0.25), (2, 16, 16)),
        "top1": (dict(E=4, k=1, cf=16.0), (1, 5, 16)),
        "deepseek_decode": (dict(E=64, k=6, shared=2, cf=1.25), (4, 1, 16)),
    }[case]
    jcfg, tcfg, jp, tm = _pair(**kw)
    x = _x(shape, seed=3)
    got, aux, want, jaux = _apply_both(jcfg, tcfg, jp, tm, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=0, atol=1e-5)
    assert np.isfinite(got).all()
    if case in ("no_drops", "shared", "top1"):
        # nothing dropped: the dense oracles agree too, on both sides
        with torch.no_grad():
            oracle = t_moe.moe_apply_reference(
                tm, torch.from_numpy(x), tcfg).numpy()
        np.testing.assert_allclose(
            oracle, np.asarray(J_ORACLE(jp, jnp.asarray(x), jcfg)),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


def test_capacity_path_equals_the_oracle_on_tokens_not_dropped():
    """With drops, the tokens none of whose copies were dropped equal the
    dense oracle; the others differ from it."""
    jcfg, tcfg, jp, tm = _pair(E=8, k=2, cf=0.5)
    x = torch.from_numpy(_x((2, 16, 16), seed=5))
    T = 32
    with torch.no_grad():
        got, _ = t_moe.moe_apply(tm, x, tcfg)
        oracle = t_moe.moe_apply_reference(tm, x, tcfg)
        r = t_moe.route(tm.router, x.reshape(T, 16), tcfg,
                        t_moe.capacity(T, tcfg))
    whole = r.keep.reshape(T, 2).all(1)
    assert 0 < int(whole.sum()) < T
    np.testing.assert_allclose(got.reshape(T, 16)[whole].numpy(),
                               oracle.reshape(T, 16)[whole].numpy(),
                               rtol=0, atol=1e-5)
    assert not torch.allclose(got.reshape(T, 16)[~whole],
                              oracle.reshape(T, 16)[~whole])


def test_aux_loss_uniform_router_is_one():
    """A zero router: uniform probabilities, top-1 always expert 0, so
    aux = E * (1 * 1/E) = 1, on both sides."""
    jcfg, tcfg, jp, tm = _pair(E=4, k=1, cf=16.0)
    jp["router"] = jnp.zeros_like(jp["router"])
    with torch.no_grad():
        tm.router.zero_()
    got, aux, want, jaux = _apply_both(jcfg, tcfg, jp, tm, _x((1, 8, 16)))
    assert aux == pytest.approx(1.0, rel=1e-6) and jaux == \
        pytest.approx(1.0, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_top1_routes_to_argmax_expert():
    """Zeroing every expert's w_down but the selected ones leaves the
    output unchanged, on the port as on the reference."""
    jcfg, tcfg, jp, tm = _pair(E=4, k=1, cf=16.0)
    x = _x((1, 5, 16), seed=7)
    sel = np.argmax(x.reshape(-1, 16) @ np.asarray(jp["router"]), -1)
    with torch.no_grad():
        full, _ = t_moe.moe_apply(tm, torch.from_numpy(x), tcfg)
        mask = torch.zeros_like(tm.w_down)
        for e in np.unique(sel):
            mask[e] = tm.w_down[e]
        tm.w_down.copy_(mask)
        masked, _ = t_moe.moe_apply(tm, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(full.numpy(), masked.numpy(), rtol=0,
                               atol=1e-6)


def test_gradients_match_jax_grad():
    """d/dparams and d/dx of sum(y^2) + aux within 1e-4 of jax.grad's."""
    jcfg, tcfg, jp, tm = _pair(shared=1, cf=1.0)
    x = _x((1, 8, 16), seed=9)

    def loss(p, xx):
        y, aux = j_moe.moe_apply(p, xx, jcfg)
        return (y ** 2).sum() + aux

    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_apply(tm, xt, tcfg)
    ((y ** 2).sum() + aux).backward()
    want = _state(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4)
    assert float(tm.router.grad.norm()) > 0


def test_init_scale_and_capacity_at_the_serving_shapes():
    """The expert weights' std follows the reference's fan-in E·D and
    E·Fe (it draws (E·D, Fe) and reshapes); C is 1 at a 4-row decode and
    15 / 20 at a 4 x 32 prefill for deepseek / olmoe; the expert-parallel
    path raises."""
    _, tcfg = _cfgs(E=64, k=6)
    tm = t_moe.MoE(tcfg, torch.Generator().manual_seed(0))
    E, D, Fe = 64, 16, 24
    for w, fan_in in ((tm.w_gate, E * D), (tm.w_up, E * D),
                      (tm.w_down, E * Fe)):
        std, w = 1 / np.sqrt(fan_in), w.detach()
        assert float(w.abs().max()) <= 2 * std + 1e-7
        assert 0.7 * std < float(w.std()) < 1.0 * std
    for arch, c_pre in (("deepseek-moe-16b", 15), ("olmoe-1b-7b", 20)):
        cfg = tconfigs.get_config(arch)
        assert t_moe.capacity(4, cfg) == 1
        assert t_moe.capacity(128, cfg) == c_pre
    # a mesh without a model axis keeps the single-device path; the dense
    # path under a model axis of more than one raises (experts split
    # need moe_impl="ep", tests/test_torch_parallel_gloo.py)
    from repro_torch.launch import mesh as t_mesh
    from repro_torch.launch import sharding as t_sharding
    x = torch.randn(1, 2, 16, generator=torch.Generator().manual_seed(0))
    one = t_sharding.DistContext(t_mesh.make_serving_mesh(device="cpu"))
    for a, b in zip(t_moe.moe_apply(tm, x, tcfg, dist=one),
                    t_moe.moe_apply(tm, x, tcfg)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="moe_impl='ep'"):
        t_moe.moe_apply(tm, x, tcfg, dist=one.__class__(
            t_mesh.Mesh(("data", "model"), (1, 2), torch.device("cpu"))))
