"""The session models (``repro_torch.models.rnn``) and the classifier head
(``repro_torch.models.recommender.ff_init``, an ``FFTower``) against the
JAX package's, from the reference's params loaded through
``params_from_jax``.

Tolerances: forward outputs within 1e-5 (f32 matmuls summed in another
order, compounded over the time steps); gradients within 1e-4 (the
reference's gradient tolerance, ``models/io.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recommender as j_rec
from repro.models import rnn as j_rnn
from repro_torch.models import recommender as t_rec
from repro_torch.models import rnn as t_rnn

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _tree(cell, d_in, d_h, d_out, seed=0):
    return j_rnn.rnn_lm_init(jax.random.PRNGKey(seed), cell, d_in, d_h,
                             d_out)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cells_equal_the_reference(cell):
    d_in, d_h, B = 12, 8, 5
    tree = _tree(cell, d_in, d_h, 7)
    model = t_rnn.params_from_jax(_np(tree), cell, "cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, d_h)).astype(np.float32)
    h = rng.normal(size=(B, d_h)).astype(np.float32)
    c = rng.normal(size=(B, d_h)).astype(np.float32)
    if cell == "gru":
        got = t_rnn.gru_cell(model.cell, torch.from_numpy(h),
                             torch.from_numpy(x)).detach().numpy()
        want = np.asarray(j_rnn.gru_cell(tree["cell"], jnp.asarray(h),
                                         jnp.asarray(x)))
        np.testing.assert_allclose(got, want, **FWD)
    else:
        got = t_rnn.lstm_cell(model.cell, (torch.from_numpy(h),
                                           torch.from_numpy(c)),
                              torch.from_numpy(x))
        want = j_rnn.lstm_cell(tree["cell"], (jnp.asarray(h),
                                              jnp.asarray(c)),
                               jnp.asarray(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **FWD)


def test_lstm_forget_gate_has_the_constant_bias():
    """Zero weights and bias: f = sigmoid(0 + 1.0), i = o = 0.5, g = 0,
    so c' = sigmoid(1) * c."""
    model = t_rnn.RNNLM("lstm", 4, 3, 5)
    with torch.no_grad():
        for p in model.cell.parameters():
            p.zero_()
    c = torch.ones(2, 3)
    _, c2 = t_rnn.lstm_cell(model.cell, (torch.zeros(2, 3), c),
                            torch.zeros(2, 3))
    torch.testing.assert_close(c2, torch.sigmoid(torch.tensor(1.0)) * c)


@pytest.mark.parametrize("cell,B,T", [("gru", 4, 9), ("lstm", 4, 9),
                                      ("gru", 1, 1), ("lstm", 3, 17)])
def test_rnn_lm_apply_and_gradients_equal_the_reference(cell, B, T):
    d_in, d_h, d_out = 24, 16, 30
    tree = _tree(cell, d_in, d_h, d_out, seed=3)
    model = t_rnn.params_from_jax(_np(tree), cell, "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T, d_in)).astype(np.float32)
    w = rng.normal(size=(B, T, d_out)).astype(np.float32)

    got = t_rnn.rnn_lm_apply(model, cell, torch.from_numpy(x))
    want = j_rnn.rnn_lm_apply(tree, cell, jnp.asarray(x))
    assert got.shape == (B, T, d_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(
        t_rnn.rnn_lm_last_logits(model, cell,
                                 torch.from_numpy(x)).detach().numpy(),
        np.asarray(j_rnn.rnn_lm_last_logits(tree, cell, jnp.asarray(x))),
        **FWD)

    (got * torch.from_numpy(w)).sum().backward()
    g = jax.grad(lambda p: (j_rnn.rnn_lm_apply(p, cell, jnp.asarray(x))
                            * w).sum())(tree)
    pairs = [(model.in_proj.weight.grad.T, g["in_proj"]["w"]),
             (model.in_proj.bias.grad, g["in_proj"]["b"]),
             (model.cell.wx.grad, g["cell"]["wx"]),
             (model.cell.wh.grad, g["cell"]["wh"]),
             (model.cell.b.grad, g["cell"]["b"]),
             (model.out.weight.grad.T, g["out"]["w"]),
             (model.out.bias.grad, g["out"]["b"])]
    for t_g, j_g in pairs:
        np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), **GRAD)


def test_params_from_jax_loads_every_leaf():
    tree = _np(_tree("gru", 10, 6, 11, seed=4))
    model = t_rnn.params_from_jax(tree, "gru", "cpu")
    assert model.cell.wx.shape == (6, 18) and model.cell.wh.shape == (6, 18)
    np.testing.assert_array_equal(model.in_proj.weight.detach().numpy().T,
                                  tree["in_proj"]["w"])
    np.testing.assert_array_equal(model.cell.wh.detach().numpy(),
                                  tree["cell"]["wh"])
    np.testing.assert_array_equal(model.out.bias.detach().numpy(),
                                  tree["out"]["b"])


def test_rnn_lm_init_draws_the_reference_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    model = t_rnn.rnn_lm_init("lstm", 200, 50, 300, generator=gen,
                              device="cpu")
    tree = _tree("lstm", 200, 50, 300)
    shapes = {"in_proj.weight": (50, 200), "in_proj.bias": (50,),
              "cell.wx": (50, 200), "cell.wh": (50, 200), "cell.b": (200,),
              "out.weight": (300, 50), "out.bias": (300,)}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == shapes
    assert tree["cell"]["wx"].shape == (50, 200)
    # fan-in-scaled truncated normal (|w| <= 2 / sqrt(fan_in)), zero biases
    assert float(model.cell.wx.abs().max()) <= 2 / np.sqrt(50) + 1e-6
    assert float(model.cell.b.abs().max()) == 0.0
    with pytest.raises(ValueError):
        t_rnn.RNNLM("rnn", 2, 2, 2)


def test_ff_init_tree_loads_as_the_classifier_head():
    tree = j_rec.ff_init(jax.random.PRNGKey(5), 40, [16, 8], 12)
    tower = t_rec.params_from_jax(_np(tree), "cpu")
    x = np.random.default_rng(3).normal(size=(6, 40)).astype(np.float32)
    np.testing.assert_allclose(
        tower(torch.from_numpy(x)).detach().numpy(),
        np.asarray(j_rec.ff_apply(tree, jnp.asarray(x))), **FWD)
    fresh = t_rec.ff_init(40, [16, 8], 12, device="cpu")
    assert [tuple(layer.weight.shape) for layer in fresh.layers] == \
        [(16, 40), (8, 16), (12, 8)]
