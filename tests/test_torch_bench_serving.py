"""The serving bench twin (``repro_torch.benchmarks.bench_serving``) on the
CPU: ``--check`` holds all 16 rows' checked fields to the committed
``BENCH_serving.json`` (integers, and roundings of integers, exactly),
the SSM family's mamba2-1.3b rows among them, with no row waiting; it
never writes the file, and fails on a drifted field, a missing row or a
broken gate; ``run.py --only serving`` prints the 16 rows as the
reference's ``serving.<name>`` CSV rows."""
import contextlib
import copy
import io
import json

import pytest
import torch

from repro_torch.benchmarks import bench_kernels as bk
from repro_torch.benchmarks import bench_serving as bs
from repro_torch.benchmarks import run as run_lib
from repro_torch.kernels import common


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs files
    in parallel workers, and these CPU-heavy runs slow down many times
    over when every worker takes every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    """One ``--check --device cpu --out`` run: (stdout, snapshot rows,
    the committed file's bytes before and after, the launches)."""
    before = bs.JSON_PATH.read_bytes()
    out = tmp_path_factory.mktemp("bench") / "rows.json"
    common.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bs.main(["--check", "--device", "cpu", "--out", str(out)])
    return dict(stdout=buf.getvalue(),
                rows=json.loads(out.read_text())["rows"],
                before=before, after=bs.JSON_PATH.read_bytes(),
                launches=dict(common.LAUNCHES))


def test_check_passes_with_13_rows_and_names_the_waiting_ones(checked):
    """(Name kept from when three mamba2 rows waited.)  All 16 rows are
    built and checked, the mamba2 ones too, and none waits."""
    assert "check ok: 16 rows on cpu vs BENCH_serving.json" in \
        checked["stdout"]
    assert "not built" not in checked["stdout"]
    names = [r["name"] for r in checked["rows"]]
    committed = {r["name"]: r for r in
                 json.loads(checked["before"])["rows"]}
    assert len(names) == 16 and set(names) == set(committed)
    for mode in ("continuous", "static", "speedup"):
        assert f"mamba2-1.3b.{mode}" in names
    for r in checked["rows"]:
        for f in bs.CHECKED_FIELDS:
            if f in committed[r["name"]]:
                assert r[f] == committed[r["name"]][f], (r["name"], f)
    assert {r["impl"] for r in checked["rows"] if "impl" in r} == {"plain"}
    assert checked["launches"] == {}


def test_the_committed_file_is_never_written(checked):
    assert checked["after"] == checked["before"]


def test_check_fails_on_drift_missing_rows_and_gates(checked):
    rows = checked["rows"]
    assert bs.check_against(rows) == []
    drift = copy.deepcopy(rows)
    drift[0]["decode_steps"] += 1
    assert any("qwen1.5-0.5b.continuous.decode_steps" in f
               for f in bs.check_against(drift))
    assert any("committed rows not built" in f
               for f in bs.check_against(rows[1:]))
    slow = copy.deepcopy(rows)
    speedup = next(r for r in slow if r["name"].endswith(".speedup"))
    speedup["decode_step_speedup"] = 1.2
    assert any("speedup 1.20 < 1.5" in f for f in bs.check_against(slow))


def test_run_py_prints_the_serving_rows(checked, monkeypatch, capsys):
    monkeypatch.setattr(bs, "run", lambda device: copy.deepcopy(
        checked["rows"]))
    run_lib.main(["--only", "serving", "--device", "cpu"])
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("serving.")]
    assert len(lines) == 16 and not err
    assert "serving.qwen1.5-0.5b.speedup,0.00,1.6316" in lines
    assert "serving.sched.sharded_kill1,0.00,0.4205" in lines
    # the kernels part is ported: it prints its 69 rows, here stubbed with
    # the committed rows (tpu_us_model swapped for the port's field)
    committed = json.loads(bk.JSON_PATH.read_text())["rows"]
    kernel_rows = [{**{f: v for f, v in r.items() if f != "tpu_us_model"},
                    "h100_us_bound": 1.0} for r in committed]
    monkeypatch.setattr(bk, "run", lambda device, quick: kernel_rows)
    run_lib.main(["--quick", "--only", "kernels", "--device", "cpu"])
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("kernels.")]
    assert len(lines) == 69 and not err
    assert "kernels.qwen3-4b.embed.fwd,1.00,0.0000" in lines
