"""The paper benches' train step (``benchmarks/common.bench_step``) is the
reference's bench step: gradients, the optimizer's update, its
application, and nothing else.  Counted through the global-norm calls: it
makes only those of its optimizer's own clipping (none without
``grad_clip``), one fewer per step than ``train/trainer.make_train_step``
(whose metrics add the gradient norm), and after 3 steps its params are
bit-equal to ``make_train_step``'s on the same batches."""
import numpy as np
import pytest
import torch

from repro_torch.benchmarks.common import bench_step
from repro_torch.core.alternatives import BloomIO
from repro_torch.models import recommender as rec
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train.trainer import make_train_step

STEPS = 3


def _batches(d: int, n: int = STEPS, seed: int = 0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        p = rng.integers(-1, d, size=(8, 5))
        q = rng.integers(-1, d, size=(8, 3))
        q[:, 0] = rng.integers(0, d, size=8)
        yield torch.from_numpy(p), torch.from_numpy(q)


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_bench_step_computes_no_norm_beyond_the_optimizers(grad_clip,
                                                           monkeypatch):
    calls = []
    norm = opt_lib.global_norm

    def counted(tree):
        calls.append(1)
        return norm(tree)

    monkeypatch.setattr(opt_lib, "global_norm", counted)
    emb = BloomIO.build(d=300, m=60, k=3, device="cpu")

    def loss_fn(model, batch):
        return rec.recommender_loss(model, emb, *batch)

    models, counts = [], []
    for build in ("trainer", "bench"):
        model = rec.recommender_init(
            emb, [32], generator=torch.Generator().manual_seed(0),
            device="cpu")
        tx = opt_lib.make_optimizer("adam", 1e-2, grad_clip_norm=grad_clip)
        state = tx.init(dict(model.named_parameters()))
        if build == "trainer":
            step = make_train_step(lambda m, b: (loss_fn(m, b), {}), tx)
            run = lambda s, b: step(model, s, b)[0]   # noqa: E731
        else:
            run = bench_step(model, tx, loss_fn)
        calls.clear()
        for batch in _batches(emb.d):
            state = run(state, batch)
        counts.append(len(calls))
        models.append(model)

    clips = STEPS if grad_clip else 0
    assert counts == [clips + STEPS, clips]
    for (n, a), (_, b) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        assert torch.equal(a, b), n
