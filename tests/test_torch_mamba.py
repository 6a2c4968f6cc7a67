"""The port's Mamba-2 mixer (``repro_torch.models.mamba2``) against the JAX
package's (``repro.models.mamba2``) on the reference's params, with inputs
drawn from a numpy seed, f32.

Checked: the chunked SSD path (``mamba_apply``) against the reference's
within 2e-5, with the sequence a multiple of the chunk and not (the
zero-padded tail), one chunk and several, one group and two; the
sequential oracle ``mamba_reference`` against the reference's and against
the chunked path; prefill then one decode step against a full pass over
S + 1 tokens (within 5e-4, as the reference's own test): for S >= 3
against ``mamba_apply`` and the reference's prefill cache, and for
S = 1, 2 against ``mamba_reference`` — the reference's prefill keeps a
short conv history there (``xs_raw[:, S - 3:]``), the port left-pads it
with zeros (ROADMAP, "Findings in the reference"); the cache shapes; the
gradients against ``jax.grad`` within 1e-4; and the init (``A_log``,
``D``, the ``dt_bias`` range, the weights' fan-in std)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MambaConfig as JMambaConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import mamba2 as j_m
from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models import mamba2 as t_m

KEY = jax.random.PRNGKey(0)
# the reference's functions jitted (cfg static): many times faster on the
# CPU than op by op
J_APPLY = jax.jit(j_m.mamba_apply, static_argnums=(1,),
                  static_argnames=("return_cache",))
J_ORACLE = jax.jit(j_m.mamba_reference, static_argnums=(1,))
J_DECODE = jax.jit(j_m.mamba_decode_step, static_argnums=(1,))


def _cfgs(chunk=4, d_state=8, head_dim=8, d_model=32, n_groups=1):
    kw = dict(name="m", family="ssm", num_layers=1, d_model=d_model,
              d_ff=0, vocab=64, dtype="float32")
    mkw = dict(d_state=d_state, head_dim=head_dim, expand=2, chunk=chunk,
               n_groups=n_groups)
    return (JModelConfig(mamba=JMambaConfig(**mkw), **kw),
            ModelConfig(mamba=MambaConfig(**mkw), **kw))


def _state(jp, prefix=""):
    sd = {}
    for name, a in jp.items():
        if isinstance(a, dict) and set(a) == {"scale"}:
            sd[prefix + name] = torch.from_numpy(np.array(a["scale"]))
        elif isinstance(a, dict):
            sd.update(_state(a, f"{prefix}{name}."))
        else:
            sd[prefix + name] = torch.from_numpy(np.array(a))
    return sd


def _pair(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = j_m.mamba_init(jax.random.PRNGKey(seed), jcfg)
    tm = t_m.Mamba2(tcfg)
    tm.load_state_dict(_state(jp))
    return jcfg, tcfg, jp, tm


def _x(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.3).astype(np.float32)


@pytest.mark.parametrize("chunk,S,groups", [
    (4, 12, 1), (3, 12, 1), (12, 12, 1),    # S % chunk == 0
    (5, 12, 1), (8, 13, 1), (16, 7, 1),     # padded tail
    (4, 8, 2), (5, 11, 2),                  # two groups
])
def test_chunked_matches_the_reference_and_the_oracle(chunk, S, groups):
    jcfg, tcfg, jp, tm = _pair(chunk=chunk, n_groups=groups)
    x = _x((2, S, 32))
    want = np.asarray(J_APPLY(jp, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = t_m.mamba_apply(tm, tcfg, torch.from_numpy(x)).numpy()
        oracle = t_m.mamba_reference(tm, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-5)
    np.testing.assert_allclose(
        oracle, np.asarray(J_ORACLE(jp, jcfg, jnp.asarray(x))), rtol=0,
        atol=2e-5)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 9])
def test_prefill_cache_then_decode_matches_a_full_pass(S):
    jcfg, tcfg, jp, tm = _pair(chunk=4)
    x = _x((2, S + 1, 32), seed=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        _, cache = t_m.mamba_apply(tm, tcfg, xt[:, :S], return_cache=True)
        # the history is left-padded with zeros: the oracle's start state
        np.testing.assert_array_equal(cache["conv_x"][:, :max(3 - S, 0)]
                                      .numpy(), 0)
        y_dec, _ = t_m.mamba_decode_step(tm, tcfg, xt[:, S:S + 1], cache)
        full = t_m.mamba_apply(tm, tcfg, xt)
        oracle = t_m.mamba_reference(tm, tcfg, xt)
    assert cache["conv_x"].shape == (2, 3, 64)
    if S >= 3:
        np.testing.assert_allclose(y_dec[:, 0].numpy(),
                                   full[:, -1].numpy(), rtol=0, atol=5e-4)
        _, jcache = J_APPLY(jp, jcfg, jnp.asarray(x[:, :S]),
                            return_cache=True)
        # the decode step above advanced the port's cache in place
        _, cache = t_m.mamba_apply(tm, tcfg, xt[:, :S], return_cache=True)
        for name, a in jcache.items():
            np.testing.assert_allclose(cache[name].detach().numpy(),
                                       np.asarray(a), rtol=0, atol=2e-5,
                                       err_msg=name)
    else:
        np.testing.assert_allclose(y_dec[:, 0].numpy(),
                                   oracle[:, -1].numpy(), rtol=0, atol=5e-4)


def test_decode_state_is_constant_size():
    _, tcfg = _cfgs()
    cache = t_m.init_mamba_cache(tcfg, batch=3)
    jcache = j_m.init_mamba_cache(_cfgs()[0], batch=3)
    for name, a in jcache.items():
        assert tuple(cache[name].shape) == a.shape, name
        assert cache[name].dtype == torch.bfloat16
    assert cache["ssm"].shape == (3, 8, 8, 8)        # (B, H, N, P)


def test_decode_step_matches_the_reference():
    """One step from a nonzero cache: output and every cache leaf."""
    jcfg, tcfg, jp, tm = _pair(chunk=4)
    rng = np.random.default_rng(4)
    jcache = {k: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                             * 0.3)
              for k, a in j_m.init_mamba_cache(jcfg, 2).items()}
    x = _x((2, 1, 32), seed=5)
    want, jnew = J_DECODE(jp, jcfg, jnp.asarray(x), jcache)
    cache = {k: torch.from_numpy(np.array(a)) for k, a in jcache.items()}
    with torch.no_grad():
        got, new = t_m.mamba_decode_step(tm, tcfg, torch.from_numpy(x),
                                         cache)
    assert new is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for name, a in jnew.items():
        np.testing.assert_allclose(new[name].numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_gradients_match_jax_grad():
    jcfg, tcfg, jp, tm = _pair(chunk=4)
    x = _x((1, 10, 32), seed=6)

    def loss(p, xx):
        return (j_m.mamba_apply(p, jcfg, xx) ** 2).sum()

    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_m.mamba_apply(tm, tcfg, xt) ** 2).sum().backward()
    want = _state(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
        assert np.isfinite(p.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4)


def test_init_follows_the_reference():
    jcfg, tcfg = _cfgs(d_model=64, head_dim=16)
    jp = j_m.mamba_init(KEY, jcfg)
    tm = t_m.Mamba2(tcfg, torch.Generator().manual_seed(0))
    assert set(dict(tm.named_parameters())) == set(_state(jp))
    with torch.no_grad():
        np.testing.assert_allclose(tm.A_log.numpy(), np.asarray(jp["A_log"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(tm.D.numpy(), np.asarray(jp["D"]))
        dt = torch.nn.functional.softplus(tm.dt_bias)
        assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
        for name, fan_in in (("z_proj", 64), ("out_proj", 128),
                             ("conv_x.w", 4)):
            w = dict(tm.named_parameters())[name]
            assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) + 1e-7, name
        for name, shape in _state(jp).items():
            assert dict(tm.named_parameters())[name].shape == shape.shape
