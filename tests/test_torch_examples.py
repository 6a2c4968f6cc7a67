"""The example twins (``repro_torch.examples``) on the CPU, through
``main(argv)`` as their command line calls it, launching no kernel there.

* Each runs end to end at its smallest documented budget.  The data seed
  of the paper-task examples is ``hash(name)``, salted per process, so
  those runs are checked for range and learning.
* Each is held against the reference example (``examples/``):
  - quickstart: its encoding, its training data and its Eq. 3 top-k ids
    on its own logp equal the JAX package's (``repro.core``,
    ``repro.data``).  Its 150 Adam steps are not compared: Adam's first
    step divides each gradient by its own magnitude, so rounding-level
    gradients part the two trajectories (``test_torch_paper_bench.py``).
  - train_lm_100m: ``config_100m`` field by field, its parameter counts
    and its first printed line.
  - train_recommender and cbe_cooccurrence: both sides' ``run_task``
    calls recorded.  The calls (task, embedding, widths, steps, scale)
    must be equal.  Each call trains, as in ``test_torch_paper_bench.py``,
    from the reference's initial params, on data pinned to one seed, for
    2 steps at scale 0.06; its score agrees within 1e-3 absolute.  The
    co-occurrence line of the CBE example, from the real data, is equal.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference's root `benchmarks`
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_table5_cbe as j_t5  # noqa: E402
from benchmarks import common as j_common  # noqa: E402
from repro import core as j_core  # noqa: E402
from repro.configs.base import BloomConfig as JBloomConfig  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.models import recommender as j_rec  # noqa: E402
from repro_torch.benchmarks import bench_table5_cbe as t_t5  # noqa: E402
from repro_torch.benchmarks import common as t_common  # noqa: E402
from repro_torch.configs.base import BloomConfig  # noqa: E402
from repro_torch.core import BloomSpec, encode  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.examples import (cbe_cooccurrence, quickstart,  # noqa: E402
                                  serve_bloom_lm, train_lm_100m,
                                  train_recommender)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import recommender as t_rec  # noqa: E402

STEPS, SCALE, DATA_SEED, SCORE_ATOL = 2, 0.06, 2017, 1e-3


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs files
    in parallel workers, and these CPU-heavy runs slow down many times
    over when every worker takes every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_launches():
    common.reset_launches()
    yield
    assert common.LAUNCHES == {}


def test_quickstart(capsys):
    score, ids = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "encoded 3 items -> 12 of 1000 bits set (k=4" in out
    assert 50 / 5000 < score <= 1.0            # far above random ranking
    assert len(ids) == 5 and len(set(ids)) == 5
    assert all(0 <= i < 5000 for i in ids)


def test_serve_bloom_lm(capsys):
    ids = serve_bloom_lm.main(["--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert ids.shape == (4, 4) and (0 <= ids).all() and (ids < 512).all()
    assert "whole-batch serving (qwen3-4b 2L" in out
    assert f"generated ids (first seq): {ids[0].tolist()}" in out


def test_train_lm_100m_two_steps(tmp_path, capsys):
    model, history = train_lm_100m.main(
        ["--device", "cpu", "--steps", "2", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "model: 91M params (dense-IO equivalent: 153M) m_vocab=9984" in out
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "bloom-lm-100m" not in train_lm_100m.configs.ARCH_MODULES
    assert list(tmp_path.iterdir())             # the final checkpoint


def test_train_recommender_quick(capsys):
    rows = train_recommender.main(["--device", "cpu", "--quick"])
    assert [r["ratio"] for r in rows] == [0.0, 0.5, 0.2, 0.1]
    assert all(0 < r["score"] <= 1 and r["train_time"] > 0 for r in rows)
    assert "[MSD] BE m/d=0.1:" in capsys.readouterr().out


def test_cbe_cooccurrence(capsys):
    rows = cbe_cooccurrence.main(["--device", "cpu"])
    assert len(rows) == 1 and rows[0]["task"] == "MSD"
    assert 0 < rows[0]["be_ratio"] and 0 < rows[0]["cbe_ratio"]
    assert "CBE S_i/S_0" in capsys.readouterr().out


def test_quickstart_matches_the_reference(capsys):
    """The twin's set, data and Eq. 3 recovery against ``repro.core``."""
    _, ids = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    d, m, k = 5000, 1000, 4
    items = [[17, 423, 4999, -1]]
    u = encode(BloomSpec(d=d, m=m, k=k), torch.tensor(items))
    want_u = j_core.encode(j_core.BloomSpec(d=d, m=m, k=k),
                           jnp.array(items))
    np.testing.assert_array_equal(u.numpy(), np.asarray(want_u))
    assert (f"encoded 3 items -> {int(want_u.sum())} of {m} bits set"
            in out)
    got, want = (t_syn.make_recsys(n=2000, d=d, mean_items=8, seed=0),
                 j_syn.make_recsys(n=2000, d=d, mean_items=8, seed=0))
    for g, w in zip((*got.train(), *got.test()), (*want.train(),
                                                  *want.test())):
        np.testing.assert_array_equal(g, w)
    logp = torch.log_softmax(torch.randn(
        1, m, generator=torch.Generator().manual_seed(1)), -1)
    _, want_ids = j_core.decode_topk(j_core.BloomSpec(d=d, m=m, k=k),
                                     jnp.asarray(logp.numpy()), topk=5)
    assert ids == np.asarray(want_ids[0]).tolist()


def test_train_lm_100m_config_matches_the_reference():
    """Every field of the reference's config, the attention chunks and
    ``remat`` among them: none it sets is left out of the port's; the
    reference's other fields stay at their defaults."""
    ref = _reference_example("train_lm_100m")
    got, want = train_lm_100m.config_100m(), ref.config_100m()
    names = {f.name for f in dataclasses.fields(got)}

    def value(v):
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    def default(f):
        return (f.default if f.default_factory is dataclasses.MISSING
                else f.default_factory())

    for f in dataclasses.fields(want):
        if f.name in names:
            assert value(getattr(got, f.name)) == value(getattr(
                want, f.name)), f.name
    left_out = {f.name for f in dataclasses.fields(want)
                if f.name not in names and getattr(want, f.name) != default(f)}
    assert left_out == set()
    assert (got.attn_chunk_q, got.attn_chunk_k, got.remat) == (64, 64,
                                                               "none")
    assert got.param_count() == want.param_count()
    assert got.m_vocab == want.m_vocab
    assert (dataclasses.replace(got, bloom=BloomConfig(enabled=False))
            .param_count() == dataclasses.replace(
                want, bloom=JBloomConfig(enabled=False)).param_count())


@functools.lru_cache(maxsize=None)
def _pinned_task_data(name, scale):
    """``task_data`` of a recsys task with the data seed pinned (both
    sides read this)."""
    t = j_common.PAPER_TASKS[name]
    assert t.kind == "recsys", name
    return j_syn.make_recsys(n=max(int(t.n * scale), 300), d=t.d,
                             mean_items=t.mean_items, seed=DATA_SEED)


def _recorded(run_task, calls):
    """``run_task`` recording each call, and training STEPS at SCALE."""
    def run(name, emb, steps, scale, **kw):
        res = run_task(name, emb, steps=STEPS, scale=SCALE, **kw)
        spec = getattr(emb, "spec_out", None)
        calls.append(((name, emb.name, emb.m_in, emb.m_out,
                       getattr(spec, "k", None), steps, scale),
                      res["score"]))
        return res
    return run


@pytest.fixture
def shared_start(monkeypatch):
    """Both sides on pinned data, the port's recommender drawn as the
    reference's ``recommender_init`` with ``PRNGKey(0)`` draws it."""
    def init(emb, hidden, *a, **kw):
        tree = j_rec.ff_init(jax.random.PRNGKey(0), emb.m_in, list(hidden),
                             emb.m_out)
        return t_rec.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    monkeypatch.setattr(t_rec, "recommender_init", init)
    monkeypatch.setattr(j_common, "task_data", _pinned_task_data)
    monkeypatch.setattr(t_common, "task_data", _pinned_task_data)


def _same_calls(got, want):
    assert [c for c, _ in got] == [c for c, _ in want] and got
    for (call, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=SCORE_ATOL), call


def test_train_recommender_matches_the_reference(monkeypatch, capsys,
                                                 shared_start):
    ref = _reference_example("train_recommender")
    got, want = [], []
    monkeypatch.setattr(ref, "run_task", _recorded(ref.run_task, want))
    monkeypatch.setattr(sys, "argv", ["train_recommender.py", "--quick"])
    ref.main()
    monkeypatch.setattr(train_recommender, "run_task",
                        _recorded(train_recommender.run_task, got))
    rows = train_recommender.main(["--device", "cpu", "--quick"])
    _same_calls(got, want)
    assert [r["score"] for r in rows] == [s for _, s in got]


def test_cbe_cooccurrence_matches_the_reference(monkeypatch, shared_start):
    got, want = [], []
    monkeypatch.setattr(j_t5, "run_task", _recorded(j_t5.run_task, want))
    monkeypatch.setattr(t_t5, "run_task", _recorded(t_t5.run_task, got))
    printed = []
    for run in (lambda: runpy.run_path(str(ROOT / "examples"
                                           / "cbe_cooccurrence.py")),
                lambda: cbe_cooccurrence.main(["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        printed.append(buf.getvalue().splitlines())
    _same_calls(got, want)
    assert printed[0][0] == printed[1][0]       # the co-occurrence line
    assert "input co-occurrence" in printed[0][0]
