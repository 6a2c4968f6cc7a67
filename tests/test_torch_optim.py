"""Every optimizer ``make_optimizer`` names (``repro_torch.optim``) against
the JAX package's on the same gradients: one step and ten, each step's
updates and the params after it within rtol 1e-6 (the same f32
operations in the same order; the global norm of the clipping sums its
leaves in another order).  An update that differs in its last bit moves
``p + u`` by up to one ulp of the O(1) params, so the params also get an
atol of 1e-7 (one f32 ulp at 1.0) for elements that cancel towards 0.
Params of one, two and three dims, so Adafactor's factored and
unfactored moments both run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import optimizers as j_opt
from repro.train import trainer as j_trainer
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import trainer as t_trainer

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}

CASES = [
    pytest.param(dict(optimizer="adam"), id="adam"),
    pytest.param(dict(optimizer="adamw", weight_decay=0.1), id="adamw"),
    pytest.param(dict(optimizer="adafactor"), id="adafactor"),
    pytest.param(dict(optimizer="adafactor", weight_decay=0.05,
                      grad_compression="bf16"), id="adafactor-wd-bf16"),
    pytest.param(dict(optimizer="adagrad"), id="adagrad"),
    pytest.param(dict(optimizer="rmsprop"), id="rmsprop"),
    pytest.param(dict(optimizer="sgd"), id="sgd"),
    pytest.param(dict(optimizer="sgd", momentum=0.9), id="sgd-momentum"),
    pytest.param(dict(optimizer="sgd", momentum=0.99, grad_clip_norm=0.5,
                      grad_compression="bf16"), id="sgd-momentum-clip-bf16"),
    pytest.param(dict(optimizer="rmsprop", grad_clip_norm=1.0,
                      warmup_steps=3), id="rmsprop-clip-warmup"),
]


@pytest.mark.parametrize("n_steps", [1, 10])
@pytest.mark.parametrize("kw", CASES)
def test_optimizer_steps_match_the_reference(kw, n_steps):
    kw = dict(dict(learning_rate=3e-2, grad_clip_norm=0.0, warmup_steps=0,
                   steps=n_steps), **kw)
    jtx = j_trainer.make_optimizer(JTrainConfig(**kw))
    ttx = t_trainer.make_optimizer(TrainConfig(**kw))
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(n_steps):
        grads = {k: (2.0 * rng.normal(size=s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        jp = j_opt.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v)
                             for k, v in grads.items()}, ts, tp)
        tp = t_opt.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_adafactor_state_is_the_reference_layout():
    """Factored moments (row and column means) for ndim >= 2, a full one
    below, a bf16 first moment; the same leaves and shapes as the
    reference's state, so a checkpoint of either holds the same arrays."""
    tx = t_opt.scale_by_adafactor()
    jtx = j_opt.scale_by_adafactor()
    tp = {k: torch.zeros(s) for k, s in SHAPES.items()}
    st = tx.init(tp)
    jst = jtx.init({k: jnp.zeros(s) for k, s in SHAPES.items()})
    for k, s in SHAPES.items():
        t_leaf, j_leaf = st["s"][k], jst["s"][k]
        assert t_leaf["mu"].dtype == torch.bfloat16
        assert sorted(t_leaf["nu"]) == sorted(j_leaf["nu"])
        for name, v in t_leaf["nu"].items():
            assert tuple(v.shape) == j_leaf["nu"][name].shape, (k, name)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_trainer.make_optimizer(TrainConfig(optimizer="lamb"))


def test_scale_matches():
    rng = np.random.default_rng(3)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    ju, _ = j_opt.scale(-0.25).update(
        {k: jnp.asarray(v) for k, v in g.items()}, (), None)
    tu, _ = t_opt.scale(-0.25).update(
        {k: torch.from_numpy(v) for k, v in g.items()}, (), None)
    for k in SHAPES:
        assert np.array_equal(tu[k].numpy(), np.asarray(ju[k])), k
