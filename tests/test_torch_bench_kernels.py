"""The kernel bench twin (``repro_torch.benchmarks.bench_kernels``) on the
CPU: its 69 rows carry ``BENCH_kernels.json``'s names in its order and
every committed field's value (the reference's byte models at the
production shapes, the check shapes, the rounded ratios) but two:
``max_err`` (the port's route against its oracle, within the reference's
slack) and ``tpu_us_model``, which becomes ``h100_us_bound`` (the port
kernel's least bytes over 3.35 TB/s).  ``check_against`` passes them and
fails on a drifted field, a dropped row and each gate; the copied byte
models equal the reference's functions; ``run.py --only kernels`` prints
the 69 rows; the committed file is never written; ``--measure`` refuses
the CPU.  The reference is imported inside the tests that use it, so the
``cuda``-marked case runs on a machine without JAX (``--noconftest``)."""
import contextlib
import copy
import io
import itertools
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import bench_kernels as bk
from repro_torch.benchmarks import run as run_lib
from repro_torch.kernels import bloom_ce as ce_lib
from repro_torch.kernels import bloom_decode_topk as dt_lib
from repro_torch.kernels import common
from repro_torch.launch.roofline import HBM_BW


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs, as the suite runs
    files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checked():
    """One ``run`` on the CPU: (rows, the committed rows, the committed
    file's bytes before and after, the launches)."""
    before = bk.JSON_PATH.read_bytes()
    common.reset_launches()
    rows = bk.run("cpu")
    return dict(rows=rows, committed=json.loads(before)["rows"],
                before=before, after=bk.JSON_PATH.read_bytes(),
                launches=dict(common.LAUNCHES))


def test_rows_equal_the_committed_snapshot(checked):
    rows, committed = checked["rows"], checked["committed"]
    assert [r["name"] for r in rows] == [r["name"] for r in committed]
    assert len(rows) == 69
    for r, old in zip(rows, committed):
        assert set(r) == set(old) - {"tpu_us_model"} | {"h100_us_bound"}, \
            r["name"]
        for f in set(old) - {"tpu_us_model", "max_err"}:
            assert r[f] == old[f], (r["name"], f)
        assert r["max_err"] <= old["max_err"] + 1e-3, r["name"]
        assert 0 < r["h100_us_bound"] < math.inf, r["name"]
    assert bk.check_against(rows) == []
    assert checked["launches"] == {}      # the plain twins launch nothing


def test_bounds_are_the_port_kernels_least_bytes(checked):
    by = {r["name"]: r for r in checked["rows"]}
    d, m, k, T, B = 151_936, 30_464, 4, 4096, 8

    def us(nbytes):
        return 1e6 * nbytes / HBM_BW

    assert by["qwen3-4b.ce.fwd"]["h100_us_bound"] == \
        us(ce_lib.min_bytes(T, m, k))
    assert by["qwen3-4b.ce.bwd"]["h100_us_bound"] == \
        us(ce_lib.min_bytes(T, m, k, backward=True))
    assert by["qwen3-4b.decode_topk"]["h100_us_bound"] == \
        us(dt_lib.min_bytes(B, B, m=m, d=d, k=k, topk=16))
    assert by["qwen3-4b.decode_topk.int8"]["h100_us_bound"] == \
        us(dt_lib.min_bytes(B, B, m=m, d=d, k=k, topk=16, logp_itemsize=1,
                            inkernel_hash=True, row_scales=True))
    assert by["qwen3-4b.decode_topk.occ12"]["h100_us_bound"] == \
        us(dt_lib.min_bytes(8, 64, m=m, d=d, k=k, topk=16))


def _set(rows, row_name, **fields):
    out = copy.deepcopy(rows)
    next(r for r in out if r["name"] == row_name).update(fields)
    return out


@pytest.mark.parametrize("edit,want", [
    (lambda rows: _set(rows, "qwen3-4b.embed.fwd", bytes=1),
     "qwen3-4b.embed.fwd: bytes model changed"),
    (lambda rows: rows[1:], "qwen3-4b.embed.fwd: bench row disappeared"),
    (lambda rows: _set(rows, "qwen3-4b.embed.fwd", name="qwen3-4b.embed"),
     "qwen3-4b.embed: missing from BENCH_kernels.json"),
    (lambda rows: _set(rows, "qwen3-4b.ce.fwd", max_err=0.01),
     "qwen3-4b.ce.fwd: max_err regressed"),
    (lambda rows: _set(rows, "qwen3-4b.decode.bwd", check_m=512),
     "qwen3-4b.decode.bwd.check_m: committed 1024, fresh 512"),
    (lambda rows: _set(rows, "qwen3-4b.decode", tpu_us_model=1.0),
     "qwen3-4b.decode: fields differ"),
    (lambda rows: _set(rows, "qwen3-4b.decode_topk", hbm_ratio=2.9),
     "fused top-k HBM ratio 2.90 < 3.0"),
    (lambda rows: _set(rows, "qwen3-4b.embed.fwd.int8", vs_fp32_ratio=2.9),
     "qwen3-4b.embed.fwd.int8: int8/fp32 bytes ratio 2.90 < 3.0"),
    (lambda rows: _set(rows, "pixtral-12b.decode_topk.int8",
                       vs_bf16_ratio=1.7),
     "pixtral-12b.decode_topk.int8: int8/bf16 bytes ratio 1.70 < 1.8"),
    (lambda rows: _set(rows, "qwen3-4b.embed.bwd.csr.skew",
                       vs_dense_ratio=2.5),
     "embed.bwd.csr.skew: CSR/dense bytes ratio 2.50 < 3.0"),
    (lambda rows: _set(rows, "qwen3-4b.decode.bwd.csr", vs_dense_ratio=9.0),
     "decode.bwd.csr: CSR/dense bytes ratio 9.00 < 10.0"),
    (lambda rows: _set(rows, "qwen3-4b.decode_topk.occ50",
                       hbm_ratio_vs_full=1.4),
     "occ50: occupancy bytes ratio 1.40 < 1.5"),
    (lambda rows: _set(rows, "qwen3-4b.decode_topk.scatter_compact",
                       hbm_ratio_vs_scattered=1.4),
     "compaction bytes recovery 1.40 < 1.5"),
    (lambda rows: _set(rows, "qwen3-4b.decode_topk.scatter_compact",
                       vs_dense_ratio=1.2),
     "compacted bytes are 1.20x the dense-occupancy model"),
], ids=["bytes", "dropped", "renamed", "max_err", "field", "tpu_field",
        "topk_ratio", "int8_fp32", "int8_bf16", "embed_csr", "decode_csr",
        "occupancy", "compaction", "compact_vs_dense"])
def test_check_fails_on_drift_dropped_rows_and_each_gate(checked, edit,
                                                         want):
    failures = bk.check_against(edit(checked["rows"]))
    assert any(want in f for f in failures), failures


def test_byte_models_equal_the_references():
    """The copied CSR models and the port's ``modeled_hbm_bytes`` against
    the reference's own functions, at the three production shapes and
    around them (pure integer calls)."""
    from repro.kernels import bloom_csr as j_csr
    from repro.kernels import bloom_decode_topk as j_dt
    from repro.kernels.common import BWD_M_TILE
    assert (bk.M_TILE, bk.CSR_E_TILE) == (BWD_M_TILE, j_csr.CSR_E_TILE)
    ms = (1, 100, 512, 513, 26_112, 30_464)
    for T, k, D, m in itertools.product((1, 16, 2048, 4096), (1, 4),
                                        (1, 512, 1024, 2560, 5120), ms):
        assert bk.csr_tile_counts(m, T * k) == j_csr.csr_tile_counts(m,
                                                                     T * k)
        for binning in (True, False):
            assert bk.modeled_embed_bwd_csr_bytes(
                T, k, D, m, include_binning=binning) == \
                j_csr.modeled_embed_bwd_csr_bytes(T, k, D, m,
                                                  include_binning=binning)
    for B, d, k, m in itertools.product((1, 8, 600), (2048, 131_072,
                                                      151_936),
                                        (1, 4), ms):
        assert bk.modeled_decode_bwd_csr_bytes(B, d, k, m) == \
            j_csr.modeled_decode_bwd_csr_bytes(B, d, k, m)
    rng = np.random.default_rng(0)
    masks = [np.ones(64, bool), np.arange(64) < 8, np.arange(64) % 2 == 0,
             rng.random(64) < 0.3, np.zeros(64, bool), np.ones(13, bool)]
    for active, (m, d), b_tile in itertools.product(
            masks, ((30_464, 151_936), (26_112, 131_072), (512, 4096)),
            (1, 8)):
        for its, hashed, scales in ((4, False, False), (2, True, False),
                                    (1, True, True), (1, False, True)):
            kw = dict(m=m, d=d, k=4, topk=16, logp_itemsize=its,
                      inkernel_hash=hashed, row_scales=scales)
            assert dt_lib.modeled_hbm_bytes(active, b_tile, **kw) == \
                j_dt.modeled_hbm_bytes(active, b_tile, **kw)


def _stub(monkeypatch, rows):
    monkeypatch.setattr(bk, "run", lambda device, quick=True, measure=False:
                        copy.deepcopy(rows))


def test_run_py_prints_the_69_kernel_rows(checked, monkeypatch, capsys):
    _stub(monkeypatch, checked["rows"])
    run_lib.main(["--quick", "--only", "kernels", "--device", "cpu"])
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("kernels.")]
    assert len(lines) == 69 and not err
    assert lines[0].startswith("kernels.qwen3-4b.embed.fwd,")
    assert lines[-1].startswith(
        "kernels.pixtral-12b.decode_topk.scatter_compact,")
    _stub(monkeypatch, _set(checked["rows"], "qwen3-4b.decode", bytes=1))
    run_lib.main(["--quick", "--only", "kernels", "--device", "cpu"])
    assert "kernels: differs from BENCH_kernels.json: qwen3-4b.decode: " \
        "bytes model changed" in capsys.readouterr().err


def test_main_checks_and_never_writes(checked, monkeypatch, capsys):
    _stub(monkeypatch, checked["rows"])
    bk.main(["--quick", "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("{'bench': 'kernels'") == 69
    assert "check ok: 69 rows on cpu vs BENCH_kernels.json" in out
    _stub(monkeypatch, checked["rows"][:-1])
    with pytest.raises(SystemExit) as e:
        bk.main(["--quick", "--check", "--device", "cpu"])
    assert e.value.code == 1
    assert "REGRESSION:" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        bk.main(["--check", "--device", "cpu"])     # needs --quick
    assert bk.JSON_PATH.read_bytes() == checked["before"] == checked["after"]


def test_measure_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs --device cuda"):
        bk.run("cpu", measure=True)
    buf = io.StringIO()
    with pytest.raises(ValueError), contextlib.redirect_stdout(buf):
        bk.main(["--quick", "--measure", "--device", "cpu"])


@pytest.mark.cuda
def test_check_on_cuda(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bk.main(["--quick", "--check", "--device", "cuda"])
    assert "check ok: 69 rows on cuda" in capsys.readouterr().out
