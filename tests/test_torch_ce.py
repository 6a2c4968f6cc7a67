"""The Bloom softmax cross-entropy of the port (repro_torch.kernels.bloom_ce,
kernels.ref.bloom_ce_ref, kernels.ops.bloom_ce, core.losses and
models.io.lm_loss) against the JAX package's Pallas ``bloom_ce_pallas``
run in interpret mode, its ``ref.bloom_ce_ref`` and its losses, on the
same numpy logits and labels; the gradient from autograd (the port's
backward, ``bloom_ce_bwd_plain`` on the CPU) against ``jax.grad``.

Tolerances: loss and gradient within 1e-6 absolute plus 1e-6 relative
(a few f32 ulps at the values' size), because the two packages sum the
exp-sum and the k picked logits in another order.  Labels -1 (masked
positions) and rows whose k hashes repeat a column are included, and the
cases the Hopper kernels branch on (k = 1, 2, 4, 8 and others, m not a
multiple of 4, -inf columns and rows, a shard no label falls in), where
non-finite entries must be non-finite on both sides.  On the CPU the
entry takes the plain versions and launches nothing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import losses as jlosses
from repro.core.bloom import BloomSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bloom_ce import bloom_ce_bwd_pallas, bloom_ce_pallas
from repro.models import io as j_io
from repro_torch import configs as tconfigs
from repro_torch.core import losses
from repro_torch.kernels import bloom_ce as ce
from repro_torch.kernels import common, ops, ref
from repro_torch.models import io as t_io

SHAPES = [(1, 8, 1), (7, 128, 3), (16, 96, 4), (19, 37, 2), (5, 512, 4)]


def _inputs(T, m, k, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    z = (3.0 * rng.normal(size=(T, m))).astype(np.float32)
    h = rng.integers(0, m, size=(T, k)).astype(np.int32)
    if dup and k > 1:
        h[::2, 1] = h[::2, 0]            # a column hashed twice
    g = rng.normal(size=(T,)).astype(np.float32)
    return z, h, g


@pytest.mark.parametrize("T,m,k", SHAPES)
@pytest.mark.parametrize("dup", [False, True])
def test_plain_forward_matches_pallas_and_ref(T, m, k, dup):
    z, h, _ = _inputs(T, m, k, dup=dup)
    loss, lse = ce.bloom_ce_plain(torch.from_numpy(z), torch.from_numpy(h))
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (T,)
    pallas = np.asarray(bloom_ce_pallas(jnp.asarray(z), jnp.asarray(h),
                                        interpret=True))
    for want in (pallas, np.asarray(jref.bloom_ce_ref(jnp.asarray(z),
                                                      jnp.asarray(h)))):
        np.testing.assert_allclose(loss.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(jnp.asarray(z), -1)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ref.bloom_ce_ref(torch.from_numpy(z), torch.from_numpy(h)).numpy(),
        pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,m,k", SHAPES)
@pytest.mark.parametrize("dup", [False, True])
def test_gradient_matches_jax_grad(T, m, k, dup):
    z, h, g = _inputs(T, m, k, seed=1, dup=dup)
    tz = torch.from_numpy(z).requires_grad_()
    (ce.bloom_ce(tz, torch.from_numpy(h)) * torch.from_numpy(g)).sum() \
        .backward()
    for fn in (lambda a: bloom_ce_pallas(a, jnp.asarray(h), interpret=True),
               lambda a: jref.bloom_ce_ref(a, jnp.asarray(h))):
        want = jax.grad(lambda a: jnp.sum(fn(a) * g))(jnp.asarray(z))
        np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_backward_counts_a_repeated_hash_twice():
    z = torch.zeros(1, 8)
    h = torch.tensor([[3, 3, 5]], dtype=torch.int32)
    loss, lse = ce.bloom_ce_plain(z, h)
    dz = ce.bloom_ce_bwd_plain(torch.ones(1), z, h, lse)
    want = torch.full((1, 8), 1 / 8)
    want[0, 3] -= 2 / 3
    want[0, 5] -= 1 / 3
    torch.testing.assert_close(dz, want, rtol=0, atol=1e-7)
    assert float(loss) == pytest.approx(float(np.log(8)), abs=1e-6)


def test_dz_keeps_the_logits_dtype():
    z, h, _ = _inputs(4, 64, 3)
    tz = torch.from_numpy(z).to(torch.bfloat16).requires_grad_()
    ce.bloom_ce(tz, torch.from_numpy(h)).sum().backward()
    assert tz.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_ops_and_lm_loss_match_the_reference(masked):
    """ops.bloom_ce, io.lm_loss and the oracles in core.losses on (B, S, m)
    logits with labels -1 at masked positions."""
    jcfg = jconfigs.get_smoke_config("qwen1.5-0.5b")
    tcfg = tconfigs.get_smoke_config("qwen1.5-0.5b")
    B, S, m, d = 2, 9, tcfg.m_vocab, tcfg.vocab
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.normal(size=(B, S, m))).astype(np.float32)
    labels = rng.integers(0, d, size=(B, S)).astype(np.int32)
    valid = None
    if masked:
        labels[:, -3:] = -1
        valid = (labels >= 0).astype(np.float32)
    spec = t_io.vocab_spec(tcfg)
    jspec = JSpec(d=spec.d, m=spec.m, k=spec.k, seed=spec.seed)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    tvalid = None if valid is None else torch.from_numpy(valid)

    got = ops.bloom_ce(tl, tlab, spec)
    want = jops.bloom_ce(jnp.asarray(logits), jnp.asarray(labels), jspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    oracle = jlosses.bloom_xent_label(jspec, jnp.asarray(logits),
                                      jnp.asarray(labels))
    np.testing.assert_allclose(losses.bloom_xent_label(spec, tl, tlab)
                               .numpy(), np.asarray(oracle), rtol=1e-6,
                               atol=1e-6)
    jv = None if valid is None else jnp.asarray(valid)
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(jcfg, io_impl=impl)
        want = j_io.lm_loss(None, c, jnp.asarray(logits),
                            jnp.asarray(labels), jv)
        np.testing.assert_allclose(
            t_io.lm_loss(tcfg, tl, tlab, tvalid).numpy(), np.asarray(want),
            rtol=1e-6, atol=1e-6)
    # the dense-vocab path
    dense = (2.0 * rng.normal(size=(B, S, 40))).astype(np.float32)
    dlab = np.where(labels >= 0, labels % 40, -1).astype(np.int32)
    want = jlosses.softmax_xent_label(jnp.asarray(dense), jnp.asarray(dlab),
                                      jv)
    got = losses.softmax_xent_label(torch.from_numpy(dense),
                                    torch.from_numpy(dlab), tvalid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# the cases the Hopper kernels branch on: k held in registers (1, 2, 4, 8)
# or read per element (3, 5); m a multiple of 4 (16-byte loads) or not
EDGE = [(6, 64, 1), (6, 64, 2), (6, 64, 4), (6, 64, 8), (6, 64, 3),
        (6, 37, 5), (5, 38, 4)]


def _finite_close(got, want, what, rtol=1e-6, atol=1e-6):
    """Equal where each is finite, the same entries non-finite (the
    finite-mask rule of chip_smoke's ``_max_abs_err``)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("T,m,k", EDGE)
def test_plain_pair_matches_pallas_on_the_kernels_cases(T, m, k):
    """Repeated labels (a column hashed two and three times), -inf columns
    in a row and a row of -inf alone: loss, lse and dz of the plain
    versions against ``bloom_ce_pallas`` / ``bloom_ce_bwd_pallas`` in
    interpret mode, non-finite entries where theirs are."""
    z, h, g = _inputs(T, m, k, seed=2, dup=True)
    if k >= 3:
        h[1, 2] = h[1, 1] = h[1, 0]
    z[2, 3:9] = -np.inf
    z[4] = -np.inf
    loss, lse = ce.bloom_ce_plain(torch.from_numpy(z), torch.from_numpy(h))
    jz, jh = jnp.asarray(z), jnp.asarray(h)
    _finite_close(loss.numpy(), bloom_ce_pallas(jz, jh, interpret=True),
                  "loss")
    _finite_close(lse.numpy(), jax.nn.logsumexp(jz, -1), "lse")
    dz = ce.bloom_ce_bwd_plain(torch.from_numpy(g), torch.from_numpy(z),
                               torch.from_numpy(h), lse)
    want = bloom_ce_bwd_pallas(jnp.asarray(g), jz, jh,
                               jnp.asarray(lse.numpy()), interpret=True)
    _finite_close(dz.numpy(), want, "dz")


@pytest.mark.parametrize("m", [64, 38])
def test_ranged_pair_with_every_label_outside_the_shard(m):
    """A shard [lo, lo + m) that no label falls in: the ranged forward's
    local lse is the shard's logsumexp and its hit sum 0.0; the ranged
    backward with the global lse is ``jax.grad`` of the whole row's
    ``bloom_ce_pallas`` loss on the shard's columns (no count there)."""
    T, k, lo = 5, 4, 40
    z, _, g = _inputs(T, lo + m, k, seed=4)
    h = np.random.default_rng(5).integers(0, lo, size=(T, k)) \
        .astype(np.int32)
    zs = torch.from_numpy(np.ascontiguousarray(z[:, lo:]))
    lse_loc, hits = ce.bloom_ce_shard_plain(zs, torch.from_numpy(h), lo)
    np.testing.assert_allclose(
        lse_loc.numpy(), np.asarray(jax.nn.logsumexp(jnp.asarray(z[:, lo:]),
                                                     -1)),
        rtol=1e-6, atol=1e-6)
    assert torch.equal(hits, torch.zeros(T))
    lse = torch.from_numpy(np.array(jax.nn.logsumexp(jnp.asarray(z), -1)))
    dz = ce.bloom_ce_bwd_plain(torch.from_numpy(g), zs, torch.from_numpy(h),
                               lse, lo)
    want = jax.grad(lambda a: jnp.sum(bloom_ce_pallas(
        a, jnp.asarray(h), interpret=True) * g))(jnp.asarray(z))
    np.testing.assert_allclose(dz.numpy(), np.asarray(want)[:, lo:],
                               rtol=1e-6, atol=1e-6)


def test_cpu_entry_launches_nothing():
    z, h, _ = _inputs(6, 64, 3)
    common.reset_launches()
    tz = torch.from_numpy(z).requires_grad_()
    ce.bloom_ce(tz, torch.from_numpy(h)).sum().backward()
    assert common.LAUNCHES == {}
    with pytest.raises(ValueError, match="one device"):
        ce.bloom_ce(tz, torch.from_numpy(h).to("meta"))
