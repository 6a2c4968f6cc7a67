"""Meshes: the data-axis layout of the sharded slot pool on one device, and
the (data, model) meshes of a world of ranks over ``torch.distributed``.

The JAX package's meshes are ``jax.make_mesh`` over real devices; with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` one CPU process
simulates N hosts, one per ``data`` shard.  The port has two kinds:

* on ONE device (no world): a ``Mesh`` names the axes, their sizes and
  that device.  ``data`` counts simulated hosts, each owning a contiguous
  slot range of the serving pool on the mesh's device
  (``launch/sharding.slot_pool_pspecs``); ``model`` is 1.
* over a WORLD of ranks (``torch.distributed`` initialised, one process
  a rank): the mesh also holds this rank's place, ``rank`` and its
  ``coords`` (row-major over the axes, as ``jax.make_mesh`` orders its
  devices), and one process group per axis over the ranks that share
  every other coordinate, plus ``batch``, the group over all batch axes
  (the axes but ``model``), and ``world``, every rank (a cache sequence
  split over every axis).  Each rank holds its local shard of every
  leaf (``launch/sharding``) and the step calls the collectives through
  the mesh's ``transport`` (``launch/collectives``).

``make_production_mesh`` is the reference's 16x16 (2x16x16 multi-pod)
mesh over a world of 256 (512) ranks: in the tests that world is the
``fake`` process-group backend.  A ``model`` axis of more than one needs
a world of that many ranks and raises, with the reason, without one.
The dry run (launch/dryrun.py) needs no world: ``counting_mesh`` is rank
0 of a mesh of any shape (the production mesh's ``MeshConfig`` shape by
default) on the ``meta`` device, its groups
``collectives.CountedGroup``s and its transport a
``collectives.CountingTransport``.
The sharded serving pool (``make_serving_mesh``) takes either kind: on
one device its data shards are simulated hosts of one pool; given the
transport of a world of ``n_hosts * model_parallel`` ranks each data
shard's slot rows live on its own ranks, split over ``model``
(serving/sharded_pool.py), and a prefill runs on its data shard's model
group alone (``model_mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.collectives import CountedGroup, CountingTransport


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes: on one device (``groups`` None), or over a world of
    ranks, this one being ``rank`` (``groups``: axis name or "batch" ->
    process group; ``transport``: launch/collectives.Transport)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    rank: int = 0
    groups: Optional[Dict[str, object]] = dataclasses.field(
        default=None, compare=False, repr=False)
    transport: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (all 0 on one device)."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank,
                                                          self.sizes))))

    @property
    def distributed(self) -> bool:
        return self.groups is not None


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _mesh(shape, axes, device: torch.device) -> Mesh:
    assert len(shape) == len(axes) and all(s >= 1 for s in shape), (
        shape, axes)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(axes), tuple(int(s) for s in shape), device)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _needs_world(model_parallel: int, what: str) -> None:
    """Raise, with the reason, unless a world of ``model_parallel`` ranks
    or more exists."""
    if model_parallel > _world_size():
        raise NotImplementedError(
            f"{what}: a `model` axis of {model_parallel} shards each leaf "
            f"over {model_parallel} ranks, and the world has "
            f"{_world_size()} (ROADMAP A13b: launch/train.py --mesh DxM "
            "starts a world)")


def world_mesh(shape, axes=("data", "model"), device=None,
               transport=None) -> Mesh:
    """The mesh ``shape`` over the initialised world (its size must be
    prod(shape)), with a process group per axis and ``batch`` for the
    batch axes.  Every rank must call it, in the same order as its other
    group creations (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh over ranks needs an "
                           "initialised torch.distributed world")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh {shape} over axes {axes} needs a world of "
                         f"{math.prod(shape)} ranks, have {world}")
    ranks = np.arange(world).reshape(shape)

    def groups_over(dims):
        """The group of ``rank`` among those along ``dims`` (all rows
        created, as every rank must)."""
        rest = [d for d in range(len(shape)) if d not in dims]
        rows = ranks.transpose(*rest, *dims).reshape(
            -1, math.prod(shape[d] for d in dims))
        mine = None
        for row in rows:
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                mine = g
        return mine

    groups = {a: groups_over([i]) for i, a in enumerate(axes)}
    batch = [i for i, a in enumerate(axes) if a != "model"]
    groups["batch"] = (None if not batch else groups[axes[batch[0]]]
                       if len(batch) == 1 else groups_over(batch))
    groups["world"] = dist.group.WORLD
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axes, shape, device, rank, groups, transport)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         transport=None) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 two pods (512 ranks), over
    the initialised world of that size (``MeshConfig``)."""
    mc = MeshConfig(multi_pod=multi_pod)
    if _world_size() != math.prod(mc.shape):
        raise NotImplementedError(
            f"the production mesh {mc.shape} needs a world of "
            f"{math.prod(mc.shape)} ranks (ROADMAP A13b), and the world "
            f"has {_world_size()}")
    return world_mesh(mc.shape, mc.axes, device, transport)


def counting_mesh(shape=None, axes=None,
                  transport: Optional[CountingTransport] = None) -> Mesh:
    """Rank 0 of a mesh of ``shape`` over ``axes`` with no world, on the
    ``meta`` device: the dry run's stand-in for one rank.  ``shape``
    defaults to the production mesh's (``MeshConfig()``), ``axes`` to
    (data, model), or (pod, data, model) for three axes.  Each axis's
    group, and ``batch`` (the axes but ``model``), is a ``CountedGroup``
    of its size; every collective goes to ``transport`` (a new
    ``CountingTransport`` by default), which counts it."""
    shape = MeshConfig().shape if shape is None else shape
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh {shape} over axes {axes}")
    groups = {a: CountedGroup(n) for a, n in zip(axes, shape)}
    groups["batch"] = CountedGroup(math.prod(
        n for a, n in zip(axes, shape) if a != "model"))
    groups["world"] = CountedGroup(math.prod(shape))
    return Mesh(axes, shape, torch.device("meta"), 0, groups,
                transport or CountingTransport())


def make_local_mesh(axes=("data", "model"), device=None,
                    transport=None) -> Mesh:
    """Whatever ranks exist, as a (1, ..., n) mesh (the reference's mesh
    for tests and CPU entry points): the world's ranks when one is
    initialised, else the devices of the chosen kind (a model axis of
    more than one then raises: it needs a world)."""
    if dist.is_initialized():
        n = _world_size()
        return world_mesh((1,) * (len(axes) - 1) + (n,), axes, device,
                          transport)
    device = resolve_device(device)
    n = _device_count(device)
    _needs_world(n if len(axes) > 1 else 1, "make_local_mesh")
    return _mesh((1,) * (len(axes) - 1) + (n,), axes, device)


def make_serving_mesh(n_hosts: Optional[int] = None,
                      model_parallel: int = 1, device=None,
                      transport=None) -> Mesh:
    """Serving-pool mesh: one ``data`` shard per host, ``model`` fixed at
    ``model_parallel``.

    With a ``transport`` (launch/collectives.Transport, the backend of the
    initialised world) it is ``world_mesh((n_hosts, model_parallel))``
    over that world, which must hold ``n_hosts * model_parallel`` ranks
    (``n_hosts`` None: the world's size over ``model_parallel``): each
    host's slot rows live on its own ranks, and every rank calls it.
    Without one every host is a simulated data shard of one pool on
    ``device``, whether or not a world exists; ``n_hosts`` defaults to
    the device count of the chosen kind (as the reference's defaults to
    ``jax.device_count()``), and a ``model`` axis of more than one
    raises: it needs a world of ranks."""
    if transport is not None:
        if n_hosts is None:
            n_hosts = _world_size() // model_parallel
        return world_mesh((n_hosts, model_parallel), ("data", "model"),
                          device, transport)
    device = resolve_device(device)
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the sharded slot pool on "
            "one device serves model_parallel=1; a `model` axis needs a "
            f"world of n_hosts x {model_parallel} ranks and its transport "
            "(ROADMAP A13b: launch/serve.py --sharded --mesh DxM starts "
            "one)")
    if n_hosts is None:
        n_hosts = _device_count(device)
    return _mesh((n_hosts, 1), ("data", "model"), device)


def model_mesh(mesh: Mesh) -> Mesh:
    """This rank's ``model`` group of a world mesh as a mesh of its own,
    ``data`` 1: the ranks of one data shard, which run a computation of
    that shard alone (a sharded pool's prefill) without entering any
    collective over ``data``.  ``rank`` is the rank's model coordinate;
    ``batch`` has no group (one shard) and ``world`` is the model
    group."""
    if not mesh.distributed:
        raise ValueError("model_mesh takes a mesh over a world of ranks")
    n_model = mesh.shape.get("model", 1)
    group = mesh.groups["model"]
    return Mesh(("data", "model"), (1, n_model), mesh.device,
                mesh.coords.get("model", 0),
                {"data": None, "model": group, "batch": None,
                 "world": group}, mesh.transport)


def make_elastic_mesh(n_devices: int, axes=("data", "model"),
                      model_parallel: int = 1, device=None,
                      transport=None) -> Mesh:
    """Rebuild a mesh after a world-size change (a host lost or added):
    ``model_parallel`` stays fixed and the rest goes to ``data``.  Over
    the world when it has ``n_devices`` ranks; else on one device, which
    takes ``model_parallel`` 1 only."""
    assert n_devices % model_parallel == 0
    shape = (n_devices // model_parallel, model_parallel)
    if dist.is_initialized() and _world_size() == n_devices:
        return world_mesh(shape, axes[-2:], device, transport)
    _needs_world(model_parallel, "make_elastic_mesh")
    if model_parallel != 1:
        raise NotImplementedError(
            f"make_elastic_mesh: {n_devices} devices with model_parallel="
            f"{model_parallel} need a world of {n_devices} ranks (ROADMAP "
            f"A13b), the world has {_world_size()}")
    return _mesh(shape, axes[-2:], resolve_device(device))
