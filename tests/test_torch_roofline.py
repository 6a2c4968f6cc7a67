"""The port's roofline (``launch/roofline.py``) against the JAX package's
``launch/roofline.py``: the analytic model FLOPs and active parameter
count equal the reference's for every (arch, shape) pair, Bloom IO on and
off; the ring model over a step's collective calls equals
``parse_collectives`` on HLO lines of the same kinds, shapes and groups
(the calls recorded by the dry run's counting transport among them); and
``roofline_terms`` is the reference's formula at the H100's rates."""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as j_roofline
from repro_torch import configs as tconfigs
from repro_torch.launch import collectives as t_coll
from repro_torch.launch import roofline as t_roofline


@pytest.mark.parametrize("bloom", [True, False])
@pytest.mark.parametrize("arch", list(tconfigs.ARCH_NAMES))
def test_model_flops_equal_the_reference(arch, bloom):
    jcfg = jconfigs.get_config(arch, bloom=bloom)
    tcfg = tconfigs.get_config(arch, bloom=bloom)
    assert (t_roofline.active_param_count(tcfg)
            == j_roofline.active_param_count(jcfg))
    for shape in tconfigs.SHAPES:
        assert t_roofline.model_flops(tcfg, shape) == j_roofline.model_flops(
            jcfg, jconfigs.SHAPE_BY_NAME[shape.name]), shape.name


# (kind, result dtype/shape, operand dtype/shape, group size, the HLO
# form of the group: explicit or iota)
CALLS = [
    ("all-reduce", ("f32", (8, 128)), ("f32", (8, 128)), 4, "explicit"),
    ("all-reduce", ("bf16", (3, 5, 7)), ("bf16", (3, 5, 7)), 16, "iota"),
    ("all-gather", ("bf16", (64, 256)), ("bf16", (16, 256)), 4, "iota"),
    ("all-gather", ("f32", (2, 30208)), ("f32", (2, 1888)), 16,
     "explicit"),
    ("reduce-scatter", ("f32", (4, 32)), ("f32", (16, 32)), 4, "explicit"),
    ("all-to-all", ("f32", (16, 16)), ("f32", (16, 16)), 2, "explicit"),
    ("collective-permute", ("f32", (10,)), ("f32", (10,)), 2, "none"),
    ("all-reduce", ("s32", (64,)), ("s32", (64,)), 1, "explicit"),
]
ITEMSIZE = {"f32": 4, "bf16": 2, "s32": 4}


def _hlo(i, kind, result, operand, group, form):
    def lit(dt_shape):
        dt, shape = dt_shape
        return f"{dt}[{','.join(map(str, shape))}]{{0}}"

    if form == "explicit":
        groups = "replica_groups={{" + ",".join(
            map(str, range(group))) + "}}"
    elif form == "iota":
        groups = f"replica_groups=[{256 // group},{group}]<=[256]"
    else:
        groups = "source_target_pairs={{0,1}}"
    return (f"  %{kind}.{i} = {lit(result)} {kind}({lit(operand)} %p{i}), "
            f"{groups}")


def _bytes(dt_shape):
    dt, shape = dt_shape
    return int(np.prod(shape)) * ITEMSIZE[dt]


def test_ring_model_equals_parse_collectives():
    hlo = "\n".join(_hlo(i, *c) for i, c in enumerate(CALLS))
    want = j_roofline.parse_collectives(hlo, n_devices=256)
    got = t_roofline.ring_collectives(
        {"kind": k, "result_bytes": _bytes(r), "operand_bytes": _bytes(o),
         "group": g} for k, r, o, g, _ in CALLS)
    assert got == want
    assert set(got["per_kind"]) == set(t_roofline.COLLECTIVE_KINDS)
    with pytest.raises(ValueError, match="unknown collective kind"):
        t_roofline.ring_bytes("broadcast", 4, 4, 2)


def test_counting_transport_calls_through_the_ring_model():
    """What the dry run's transport records for an all-reduce and an
    all-gather is what ``parse_collectives`` reads off their HLO."""
    tr = t_coll.CountingTransport()
    x = torch.empty(8, 128, dtype=torch.float32, device="meta")
    assert tr.all_reduce(x, t_coll.CountedGroup(4)) is x
    y = torch.empty(16, 256, dtype=torch.bfloat16, device="meta")
    parts = tr.all_gather(y, t_coll.CountedGroup(4))
    assert len(parts) == 4 and all(p.shape == y.shape for p in parts)
    hlo = "\n".join(_hlo(i, *c) for i, c in enumerate(
        [CALLS[0], CALLS[2]]))
    assert t_roofline.ring_collectives(tr.calls) == \
        j_roofline.parse_collectives(hlo, n_devices=256)
    with pytest.raises(NotImplementedError):
        tr.broadcast(x, 0)
    with pytest.raises(ValueError, match="transport"):
        t_coll.Transport("counting")


@pytest.mark.parametrize("terms", [(1e12, 1e9, 1e8), (1e9, 1e12, 1e8),
                                   (1e9, 1e9, 1e12), (0.0, 0.0, 0.0)])
def test_roofline_terms_are_the_reference_formula_at_h100_rates(
        terms, monkeypatch):
    assert (t_roofline.PEAK_FLOPS, t_roofline.HBM_BW, t_roofline.LINK_BW,
            t_roofline.F32_PEAK_FLOPS) == (989.4e12, 3.35e12, 450e9, 67e12)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        assert getattr(t_roofline, name) != getattr(j_roofline, name)
        monkeypatch.setattr(j_roofline, name, getattr(t_roofline, name))
    assert t_roofline.roofline_terms(*terms) == \
        j_roofline.roofline_terms(*terms)


def _artifacts():
    """Dry-run artifact dicts of the reference's keys, drawn from a seed:
    single-pod cells with a roofline (each term dominant once), one
    without (a ``--no-roofline`` count), and their dense and multi-pod
    twins."""
    rng = np.random.default_rng(30)
    arts = []
    for i, (arch, shape) in enumerate([("qwen3-4b", "train_4k"),
                                       ("olmoe-1b-7b", "decode_32k"),
                                       ("whisper-small", "prefill_32k"),
                                       ("jamba-v0.1-52b", "long_500k")]):
        terms = rng.uniform(1e-4, 2.0, size=3)
        names = ("compute_s", "memory_s", "collective_s")
        full = {"memory": {"argument_bytes": int(rng.integers(1, 2 ** 36)),
                           "temp_bytes": int(rng.integers(1, 2 ** 37)),
                           "output_bytes": 0, "code_bytes": 0},
                "compile_s": float(rng.uniform(0, 90))}
        d = {"arch": arch, "shape": shape, "mesh": "16x16", "full": full}
        if i < 3:
            r = dict(zip(names, terms))
            r["dominant"] = names[i]
            r["step_time_s"] = float(terms.max())
            r["model_flops_ratio"] = float(rng.uniform(0.1, 1.2))
            d["roofline"] = r
        arts.append(d)
    return arts


def test_roofline_table_twin_equals_the_reference(tmp_path, monkeypatch):
    """``benchmarks/roofline_table.py``'s twin: ``load_cells`` from the
    artifacts' files (single-pod, dense and multi-pod tags apart),
    ``fmt_table``, ``fmt_multipod`` and ``run`` equal the reference's on
    the same artifacts, each package reading its own dry-run folder; one
    row for each artifact that has a roofline."""
    import json
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:        # the reference's root `benchmarks`
        sys.path.insert(0, root)
    from benchmarks import roofline_table as j_rt
    from repro_torch.benchmarks import roofline_table as t_rt
    arts = _artifacts()
    for folder in ("experiments/dryrun", "experiments/dryrun_torch"):
        out = tmp_path / folder
        out.mkdir(parents=True)
        for d in arts:
            for tag, mesh in (("singlepod", "16x16"),
                              ("multipod", "2x16x16")):
                for suffix in ("", "__dense"):
                    (out / f"{d['arch']}__{d['shape']}__{tag}{suffix}.json"
                     ).write_text(json.dumps(dict(d, mesh=mesh)))
    monkeypatch.chdir(tmp_path)
    for kw in ({}, {"tag": "multipod"}, {"dense": True}):
        assert t_rt.load_cells(**kw) == j_rt.load_cells(**kw)
        assert len(t_rt.load_cells(**kw)) == len(arts)
    rows = t_rt.load_cells()
    table = t_rt.fmt_table(rows)
    assert table == j_rt.fmt_table(rows)
    assert len(table.splitlines()) == 2 + 3
    multi = t_rt.load_cells(tag="multipod")
    assert t_rt.fmt_multipod(multi) == j_rt.fmt_multipod(multi)
    assert t_rt.run() == j_rt.run()
    assert [r["arch"] for r in t_rt.run()] == [
        "olmoe-1b-7b", "qwen3-4b", "whisper-small"]


def test_run_py_prints_the_reference_roofline_rows(tmp_path, monkeypatch,
                                                   capsys):
    """``benchmarks/run.py --only roofline``: the reference's
    ``roofline.<arch>.<shape>`` rows (the dominant term in us, MODEL/
    counted FLOPs) from the port's dry-run folder, the same lines as the
    reference's ``run.py`` prints from its own."""
    import json
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import run as j_run
    from repro_torch.benchmarks import run as t_run
    for folder in ("experiments/dryrun", "experiments/dryrun_torch"):
        out = tmp_path / folder
        out.mkdir(parents=True)
        for d in _artifacts():
            (out / f"{d['arch']}__{d['shape']}__singlepod.json").write_text(
                json.dumps(d))
    monkeypatch.chdir(tmp_path)
    t_run.main(["--only", "roofline", "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(sys, "argv", ["run.py", "--only", "roofline"])
    j_run.main()
    want = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in got] == [
        "roofline.olmoe-1b-7b.decode_32k", "roofline.qwen3-4b.train_4k",
        "roofline.whisper-small.prefill_32k"]
    assert got == [ln for ln in want if ln.startswith("roofline.")]
