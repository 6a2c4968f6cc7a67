"""The paper's benches in the port (``repro_torch.benchmarks``: ``common``,
the five benches, ``run``, ``paper_phase``) against the JAX package's
root ``benchmarks/`` on the CPU.

* Runners: each of ``run_recsys``, ``run_classify`` and ``run_session``
  starts from the reference's own initial params (its init with
  ``PRNGKey(seed)``, loaded into the port by patching the port's init
  here) and sees the same batches (the same data and the same
  ``BatchIterator``).  The data is pinned here to a fixed seed on both
  sides: the runners' ``hash(name)`` rule is salted per process (its
  parity is ``test_task_data_equals_the_reference``), and the comparison
  below must not depend on the salt.  After a warm-up and 2 steps at
  scale 0.06, all but 0.1% of each trained param's elements agree within
  atol 5e-5 / rtol 1e-4: f32 gradients are summed in another order, and
  Adagrad's and RMSprop's first steps divide each gradient by its own
  magnitude, so an element whose gradient is at rounding level (terms
  that cancel) takes a step of ~lr of either sign (measured over 24 data
  seeds: at most 0.063% of an array's elements, CADE's RMSprop; at most
  1.9e-4, YC's Adagrad at lr 0.01; after 5 steps one seed in 16 diverged
  in 7% of CADE's first layer, as its ReLU patterns part).  The score
  agrees within 1e-3 absolute (MAP and RR in [0, 1], accuracy in %: two
  items whose Eq. 3 scores lie within the logits' rounding swap ranks;
  the largest gap measured is 2.9e-5, MSD counting Bloom, one such swap
  among 60 test users).
* Losses and alternatives at the session tasks' shapes ((B, T, 1) id
  sets, -1 targets): within 1e-5 / 1e-6 and finite.
* The benches' rows (keys, methods, m values, ratios) and ``run.py``'s
  CSV names equal the reference's for the same arguments, with
  ``run_task`` (and the host fits, for ``run.py``) replaced on both sides
  by one deterministic stand-in.
"""
import dataclasses
import functools
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference's root `benchmarks`
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_fig1_compression as j_f1  # noqa: E402
from benchmarks import bench_fig2_hashes as j_f2  # noqa: E402
from benchmarks import bench_fig3_time as j_f3  # noqa: E402
from benchmarks import bench_table3_alternatives as j_t3  # noqa: E402
from benchmarks import bench_table5_cbe as j_t5  # noqa: E402
from benchmarks import common as j_common  # noqa: E402
from benchmarks import run as j_run  # noqa: E402
from repro.core import alternatives as j_alt  # noqa: E402
from repro.core import counting as j_cnt  # noqa: E402
from repro.core import hashing as j_hash  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.models import recommender as j_rec  # noqa: E402
from repro.models import rnn as j_rnn  # noqa: E402
from repro_torch.benchmarks import bench_fig1_compression as t_f1  # noqa
from repro_torch.benchmarks import bench_fig2_hashes as t_f2  # noqa: E402
from repro_torch.benchmarks import bench_fig3_time as t_f3  # noqa: E402
from repro_torch.benchmarks import bench_table3_alternatives as t_t3  # noqa
from repro_torch.benchmarks import bench_table5_cbe as t_t5  # noqa: E402
from repro_torch.benchmarks import common as t_common  # noqa: E402
from repro_torch.benchmarks import paper_phase  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402
from repro_torch.core import alternatives as t_alt  # noqa: E402
from repro_torch.core import counting as t_cnt  # noqa: E402
from repro_torch.core.bloom import decode_scores  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.models import recommender as t_rec  # noqa: E402
from repro_torch.models import rnn as t_rnn  # noqa: E402

PARAMS = dict(rtol=1e-4, atol=5e-5)
PARAMS_OUTSIDE = 1e-3      # the share of an array's elements allowed out
SCORE_ATOL = 1e-3
STEPS, SCALE = 2, 0.06
DATA_SEED = 2017


class _JitRecorder:
    """``jax`` with ``jit`` recording the arguments of every call, so the
    reference runner's last eval call gives its trained params."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args):
            self.calls.append(args)
            return jitted(*args)
        return call


def _embeddings(method, d):
    """(reference, port) embeddings of one method at m/d 0.2."""
    m = d // 5
    if method == "Baseline":
        return (j_common.baseline_embedding(d),
                t_common.baseline_embedding(d, "cpu"))
    if method == "BE":
        return (j_alt.BloomIO.build(d=d, m=m, k=4),
                t_alt.BloomIO.build(d=d, m=m, k=4, device="cpu"))
    if method == "HT":
        return (j_alt.hashing_trick(d, m), t_alt.hashing_trick(d, m,
                                                               device="cpu"))
    if method == "CBE-count":
        return (j_cnt.CountingBloomIO(d, m), t_cnt.CountingBloomIO(
            d, m, device="cpu"))
    X = sp.random(300, d, density=0.004, format="csr",
                  random_state=np.random.default_rng(0))
    X.data[:] = 1.0
    return (j_alt.PMIIO.build(X, 32), t_alt.PMIIO.build(X, 32, device="cpu"))


@functools.lru_cache(maxsize=None)
def _pinned_task_data(name, scale=1.0):
    """``task_data`` with the data seed pinned (both sides use this)."""
    t = j_common.PAPER_TASKS[name]
    n = max(int(t.n * scale), 300)
    if t.kind == "recsys":
        return j_syn.make_recsys(n=n, d=t.d, mean_items=t.mean_items,
                                 seed=DATA_SEED)
    if t.kind == "classify":
        return j_syn.make_classification(n=n, d=t.d, n_classes=t.n_classes,
                                         mean_items=t.mean_items,
                                         seed=DATA_SEED)
    return j_syn.make_sessions(n_sessions=n, d=t.d, mean_len=t.mean_items,
                               seed=DATA_SEED)


@pytest.mark.parametrize("name", sorted(j_common.PAPER_TASKS))
def test_task_data_equals_the_reference(name):
    """The runners' data, seeded ``hash(name) % 2**31`` by both packages:
    equal element for element within one process."""
    got, want = t_common.task_data(name, SCALE), j_common.task_data(name,
                                                                    SCALE)
    if hasattr(want, "p_in"):
        got, want = ((got.p_in, got.q_out, got.n_train),
                     (want.p_in, want.q_out, want.n_train))
    for g, w in zip(got, want):
        if sp.issparse(w):
            assert (g != w).nnz == 0
        else:
            np.testing.assert_array_equal(g, w)


def _pairs(kind, model, tree):
    """(port tensor, reference array) for every trained param."""
    if kind == "session":
        return [(model.in_proj.weight.T, tree["in_proj"]["w"]),
                (model.in_proj.bias, tree["in_proj"]["b"]),
                (model.cell.wx, tree["cell"]["wx"]),
                (model.cell.wh, tree["cell"]["wh"]),
                (model.cell.b, tree["cell"]["b"]),
                (model.out.weight.T, tree["out"]["w"]),
                (model.out.bias, tree["out"]["b"])]
    return [p for i, layer in enumerate(model.layers)
            for p in ((layer.weight.T, tree[f"l{i}"]["w"]),
                      (layer.bias, tree[f"l{i}"]["b"]))]


@pytest.mark.parametrize("name,method", [
    ("MSD", "BE"), ("MSD", "Baseline"), ("MSD", "CBE-count"),
    ("CADE", "BE"), ("YC", "BE"), ("YC", "PMI"), ("PTB", "HT")])
def test_runner_matches_the_reference_from_shared_params(
        monkeypatch, name, method):
    task = j_common.PAPER_TASKS[name]
    j_emb, t_emb = _embeddings(method, task.d)
    key = jax.random.PRNGKey(0)
    held = {}
    if task.kind == "recsys":
        tree = j_rec.recommender_init(key, j_emb, list(task.arch_hidden))
        monkeypatch.setattr(t_rec, "recommender_init", lambda *a, **k: held
                            .setdefault("m", t_rec.params_from_jax(
                                jax.tree.map(np.asarray, tree), "cpu")))
    elif task.kind == "classify":
        tree = j_rec.ff_init(key, j_emb.m_in, list(task.arch_hidden),
                             task.n_classes)
        monkeypatch.setattr(t_rec, "ff_init", lambda *a, **k: held
                            .setdefault("m", t_rec.params_from_jax(
                                jax.tree.map(np.asarray, tree), "cpu")))
    else:
        tree = j_rnn.rnn_lm_init(key, task.cell, j_emb.m_in,
                                 task.arch_hidden[0], j_emb.m_out)
        monkeypatch.setattr(t_rnn, "rnn_lm_init", lambda *a, **k: held
                            .setdefault("m", t_rnn.params_from_jax(
                                jax.tree.map(np.asarray, tree), task.cell,
                                "cpu")))
    recorder = _JitRecorder()
    monkeypatch.setattr(j_common, "jax", recorder)
    monkeypatch.setattr(j_common, "task_data", _pinned_task_data)
    monkeypatch.setattr(t_common, "task_data", _pinned_task_data)
    want = j_common.run_task(name, j_emb, steps=STEPS, scale=SCALE)
    got = t_common.run_task(name, t_emb, steps=STEPS, scale=SCALE,
                            device="cpu")
    assert set(got) == set(want) == {"score", "train_time", "eval_time"}
    assert got["score"] == pytest.approx(want["score"], abs=SCORE_ATOL)
    trained = recorder.calls[-1][0]          # the timed eval's params
    moved = 0.0
    for t_p, j_p in _pairs(task.kind, held["m"], trained):
        outside = ~np.isclose(t_p.detach().numpy(), np.asarray(j_p),
                              **PARAMS)
        assert outside.mean() <= PARAMS_OUTSIDE, (outside.mean(), np.abs(
            t_p.detach().numpy() - np.asarray(j_p)).max())
    for t_p, j_p in _pairs(task.kind, held["m"], tree):
        moved = max(moved, float(np.abs(t_p.detach().numpy()
                                        - np.asarray(j_p)).max()))
    assert moved > 1e-3                      # the params did train


def _time_axis_embeddings():
    d, m = 300, 40
    X = sp.random(200, d, density=0.02, format="csr",
                  random_state=np.random.default_rng(1))
    X.data[:] = 1.0
    H = j_hash.make_hash_matrix_np(d, 4, m, seed=2)
    return {
        "BE": (j_alt.BloomIO.build(d=d, m=m, k=4),
               t_alt.BloomIO.build(d=d, m=m, k=4, device="cpu")),
        "CBE": (j_alt.BloomIO.build(d=d, m=m, k=4, H_in=H, H_out=H),
                t_alt.BloomIO.build(d=d, m=m, k=4, H_in=H, H_out=H,
                                    device="cpu")),
        "HT": (j_alt.hashing_trick(d, m), t_alt.hashing_trick(d, m,
                                                              device="cpu")),
        "ECOC": (j_alt.ECOCIO.build(d, m, iters=5),
                 t_alt.ECOCIO.build(d, m, iters=5, device="cpu")),
        "PMI": (j_alt.PMIIO.build(X, 16), t_alt.PMIIO.build(X, 16,
                                                            device="cpu")),
        "CCA": (j_alt.CCAIO.build(X, X, 16), t_alt.CCAIO.build(
            X, X, 16, device="cpu")),
        "CBE-count": (j_cnt.CountingBloomIO(d, m),
                      t_cnt.CountingBloomIO(d, m, device="cpu")),
    }


SEQS = np.array([[5, 17, 299, 0, -1, -1], [-1, -1, -1, -1, -1, -1],
                 [42, 42, 7, 8, 9, 10]], np.int32)


@pytest.mark.parametrize("method", ["BE", "CBE", "HT", "ECOC", "PMI", "CCA",
                                    "CBE-count"])
def test_embeddings_at_the_session_shapes_match_the_reference(method):
    """encode_seq's (B, T, 1) id sets, the per-position loss on (B*T, 1)
    targets with -1 (all-pad) rows, and the decode of the last outputs:
    the reference's values within 1e-5, every loss finite (NaN * 0 would
    poison the masked mean)."""
    j_emb, t_emb = _time_axis_embeddings()[method]
    x_t = t_emb.encode_input(torch.from_numpy(SEQS)[..., None])
    x_j = np.asarray(j_emb.encode_input(jnp.asarray(SEQS)[..., None]))
    assert x_t.shape == (3, 6, t_emb.m_in)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-5, atol=1e-6)
    assert not x_t[1].any()                 # -1 positions encode to zeros

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(18, t_emb.m_out)).astype(np.float32)
    tgt = SEQS.reshape(18, 1)
    l_t = t_emb.loss(torch.from_numpy(logits), torch.from_numpy(tgt))
    l_j = np.asarray(j_emb.loss(jnp.asarray(logits), jnp.asarray(tgt)))
    assert torch.isfinite(l_t).all()
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=1e-5, atol=1e-5)
    valid = torch.from_numpy(tgt[:, 0] >= 0)
    masked = (l_t * valid).sum() / torch.clamp(valid.sum(), min=1)
    assert torch.isfinite(masked)

    s_t = t_emb.decode(torch.from_numpy(logits[:3]))
    s_j = np.asarray(j_emb.decode(jnp.asarray(logits[:3])))
    assert s_t.shape == (3, 300)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["identity", "HT", "k16", "CBE",
                                    "CBE-count"])
def test_bloom_decode_on_the_cpu_is_decode_scores(method):
    """On a CPU tensor the Eq. 3 decode is the plain ``decode_scores``,
    bit for bit, and launches no kernel (on CUDA it is the kernel: held
    bit-equal to this on the card by ``chip_smoke.py`` phase paper)."""
    d, m = 2400, 720
    H = j_hash.make_hash_matrix_np(d, 4, m, seed=1)
    emb = {"identity": t_common.baseline_embedding(d, "cpu"),
           "HT": t_alt.hashing_trick(d, m, device="cpu"),
           "k16": t_alt.BloomIO.build(d=d, m=m, k=16, device="cpu"),
           "CBE": t_alt.BloomIO.build(d=d, m=m, k=4, H_out=H, device="cpu"),
           "CBE-count": t_cnt.CountingBloomIO(d, m, device="cpu")}[method]
    pred = torch.randn(7, emb.m_out, generator=torch.Generator().manual_seed(
        0))
    kcommon.reset_launches()
    got = emb.decode(pred)
    assert kcommon.LAUNCHES == {}
    want = decode_scores(emb.spec_out, torch.log_softmax(pred, -1),
                         getattr(emb, "H_out", None))
    assert got.shape == (7, d) and torch.equal(got, want)


def _stub_run_task(name, emb, **kw):
    """A deterministic stand-in for ``run_task``: a function of the
    embedding's name and widths only, the same on both sides."""
    k = getattr(getattr(emb, "spec_out", None), "k", 0)
    return {"score": 0.1 + 0.5 * emb.m_out / emb.d + 0.01 * len(emb.name)
            + 0.001 * k,
            "train_time": 1e-3 * emb.m_out + 1e-5 * kw.get("steps", 0),
            "eval_time": 1e-4 * emb.m_in}


BENCHES = {"fig1": (j_f1, t_f1, dict(tasks=("MSD", "CADE"), scale=SCALE)),
           "fig2": (j_f2, t_f2, dict(tasks=("YC",), scale=SCALE)),
           "fig3": (j_f3, t_f3, dict(tasks=("MSD",), scale=SCALE)),
           "table3": (j_t3, t_t3, dict(points=(("YC", 0.1),),
                                       scale=SCALE)),
           "table5": (j_t5, t_t5, dict(points=(("MSD", 0.1),), scale=SCALE,
                                       max_pairs=500))}


@pytest.mark.parametrize("bench", sorted(BENCHES))
def test_bench_rows_match_the_reference(monkeypatch, bench):
    j_mod, t_mod, kw = BENCHES[bench]
    for mod in (j_mod, t_mod):
        monkeypatch.setattr(mod, "run_task", _stub_run_task)
    want = j_mod.run(steps=STEPS, **kw)
    got = t_mod.run(steps=STEPS, device="cpu", **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if isinstance(w[key], float):
                assert g[key] == pytest.approx(w[key], rel=1e-12), key
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("bench", sorted(BENCHES))
def test_bench_signatures_match_the_reference(bench):
    """The same arguments and defaults, plus ``device`` (None: CUDA)."""
    j_mod, t_mod, _ = BENCHES[bench]
    j_sig = inspect.signature(j_mod.run).parameters
    t_sig = inspect.signature(t_mod.run).parameters
    assert list(t_sig) == list(j_sig) + ["device"]
    for name, p in j_sig.items():
        assert t_sig[name].default == p.default, name
    assert t_sig["device"].default is None
    for fn in ("RATIOS", "KS"):
        if hasattr(j_mod, fn):
            assert getattr(t_mod, fn) == getattr(j_mod, fn)


@pytest.mark.parametrize("name", ["MSD", "YC", "CADE"])
def test_input_matrix_equals_the_reference(name):
    """Table 3's and 5's instance matrices (a session task's bag of
    items per session) are the reference's, exactly."""
    for got, want in zip(t_t3._input_matrix(name, SCALE),
                         j_t3._input_matrix(name, SCALE)):
        assert got.shape == want.shape
        assert (got != want).nnz == 0


def _stub_parts(monkeypatch):
    """run_task and the host fits replaced on both sides (the names of
    the CSV rows do not depend on them)."""
    X = sp.csr_matrix(np.eye(4))

    def methods(name, m, scale, seed=0, device=None):
        d = j_common.PAPER_TASKS[name].d
        return {meth: j_common.baseline_embedding(d) for meth in
                ("HT", "ECOC", "PMI", "CCA", "BE k=3", "BE k=4", "BE k=5")}

    for mods in ((j_f1, j_f2, j_f3, j_t3, j_t5),
                 (t_f1, t_f2, t_f3, t_t3, t_t5)):
        for mod in mods:
            monkeypatch.setattr(mod, "run_task", _stub_run_task)
        monkeypatch.setattr(mods[3], "build_methods", methods)
        monkeypatch.setattr(mods[4], "_input_matrix", lambda n, s: (X, X))
        monkeypatch.setattr(mods[4], "cbe_hash_matrix",
                            lambda X, H, m, **kw: H)


@pytest.mark.parametrize("quick", [True, False])
def test_run_prints_the_reference_csv_rows(monkeypatch, capsys, quick):
    _stub_parts(monkeypatch)
    only = "fig1,fig2,fig3,table3,table5"
    flags = ["--quick"] if quick else []
    monkeypatch.setattr(sys, "argv", ["run.py", *flags, "--only", only])
    j_run.main()
    want = capsys.readouterr().out.strip().splitlines()
    t_run.main([*flags, "--only", only, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    assert got == want            # the stand-in's values print the same
    assert len(got) == (32 if quick else 62)


# the case ids are the parts asked for; ``kernels`` and ``roofline`` are
# ported, so each case asks for its part beside ``fig9``, which no bench
# has and which alone refuses the whole request
@pytest.mark.parametrize("part,only", [("kernels", "kernels,fig9"),
                                       ("roofline", "roofline,kernels,fig9"),
                                       ("fig9", "fig1,fig9")],
                         ids=["kernels", "roofline", "fig9"])
def test_run_rejects_parts_it_does_not_have(capsys, part, only):
    with pytest.raises(SystemExit):
        t_run.main(["--only", only, "--device", "cpu"])
    err = capsys.readouterr().err
    assert "unknown parts ['fig9']" in err and "A14b" not in err
    assert part in t_run.PARTS or part == "fig9"


def test_run_cli_fig1_on_the_cpu():
    """``--quick --only fig1 --device cpu`` end to end in a subprocess
    (60 steps at scale 0.35 per point): the reference's six row names,
    finite ratios, the Baseline's 1.0."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--quick",
         "--only", "fig1", "--device", "cpu"],
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "2"},
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [r.split(",") for r in proc.stdout.strip().splitlines()]
    assert [r[0] for r in rows] == ["fig1.MSD.m1.00", "fig1.MSD.m0.10",
                                    "fig1.MSD.m0.20", "fig1.MSD.m0.30",
                                    "fig1.MSD.m0.50", "fig1.MSD.m0.80"]
    ratios = [float(r[2]) for r in rows]
    assert ratios[0] == 1.0 and all(0.0 < x < 10.0 for x in ratios)


def test_chance_score_is_the_metric_on_random_scores(monkeypatch):
    """The "learns" gate's yardstick: the task's own metric on seeded
    uniform random scores over its test set (the runners' test sets)."""
    from repro_torch.train import metrics as M
    monkeypatch.setattr(t_common, "task_data", _pinned_task_data)
    p_te, q_te = _pinned_task_data("MSD", SCALE).test()
    want = M.mean_average_precision(
        np.random.default_rng(0).random((len(p_te), 2400)), q_te, p_te)
    assert paper_phase.chance_score("MSD", SCALE) == want
    seqs, n_train = _pinned_task_data("YC", SCALE)
    _, tgt, idx = t_common.session_test(seqs, n_train)
    assert (idx >= 0).all() and len(tgt) <= len(seqs) - n_train
    want = M.reciprocal_rank(np.random.default_rng(0).random(
        (len(tgt), 2000)), tgt)
    assert paper_phase.chance_score("YC", SCALE) == want
    _, labels, n_train, _ = _pinned_task_data("CADE", SCALE)
    want = M.accuracy(np.random.default_rng(0).random(
        (len(labels) - n_train, 12)), labels[n_train:])
    assert paper_phase.chance_score("CADE", SCALE) == want
    assert 0.0 < paper_phase.chance_score("MSD", SCALE) < 0.05


def test_phase_records_every_run_and_checks_it():
    runs, part = [], ["tiny"]
    with paper_phase.recording(runs, part):
        for name, emb in (
                ("MSD", t_alt.BloomIO.build(d=2400, m=240, k=4,
                                            device="cpu")),
                ("CADE", t_alt.BloomIO.build(d=4000, m=800, k=4,
                                             device="cpu")),
                ("YC", t_alt.ECOCIO.build(2000, 200, iters=2,
                                          device="cpu"))):
            t_common.run_task(name, emb, steps=2, scale=SCALE, device="cpu")
    assert t_common.RUNNERS["recsys"] is t_common.run_recsys   # restored
    assert [(r.part, r.task, r.method, r.m, r.k, r.evals) for r in runs] == [
        ("tiny", "MSD", "BE", 240, 4, 2), ("tiny", "CADE", "BE", 800, 4, 0),
        ("tiny", "YC", "ECOC", 200, None, 0)]
    assert runs[0].decode_equal is True and runs[0].eval_shape == (60, 2400)
    assert all(r.launches == {} for r in runs)
    # scores that pass (2 steps do not learn CADE), then each check names
    # what broke
    good = [dataclasses.replace(r, score=s)
            for r, s in zip(runs, (0.9, 99.0, 0.9))]
    assert paper_phase.check(good, SCALE, on_card=False) == []
    bad = [dataclasses.replace(good[0], decode_equal=False),
           dataclasses.replace(good[0], launches={"bloom_decode": 2}),
           dataclasses.replace(good[0], evals=1),
           dataclasses.replace(good[0], score=1.5),
           dataclasses.replace(good[1], score=0.0),
           dataclasses.replace(good[2], score=float("nan"))]
    failures = paper_phase.check(bad, SCALE, on_card=False)
    assert len(failures) == 7, failures     # NaN: the range and the gate
    assert "< 3.0 x chance" in failures[4]
    on_card = paper_phase.check(good[:1], SCALE, on_card=True)
    assert on_card == ["tiny MSD BE m=240 k=4: launched {}, want "
                       "{'bloom_decode': 2}"]
