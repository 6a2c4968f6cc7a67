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
