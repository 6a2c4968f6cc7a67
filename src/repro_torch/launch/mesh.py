"""Serving meshes: the data-axis layout of the sharded slot pool.

The JAX package's meshes are ``jax.make_mesh`` over real devices; with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` one CPU process
simulates N hosts, one per ``data`` shard.  The port keeps that single-
process design and puts every host shard on ONE device: a ``Mesh`` here
names the axes, their sizes and that device.  ``data`` counts simulated
hosts, each owning a contiguous slot range of the pool on the mesh's
device (``launch/sharding.slot_pool_pspecs``).

Placing shards on several cards, a ``model`` axis of more than one
(kv heads split over cards) and the production mesh wait for ROADMAP
A13b; the functions below raise for them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.common import resolve_device

A13B = ("needs shards on several cards, which waits for ROADMAP A13b "
        "(placement rules, NCCL transport)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over one device: ``shape[name]`` shards of the pool each
    (``data``: simulated hosts; ``model``: 1)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _mesh(shape, axes, device: torch.device) -> Mesh:
    assert len(shape) == len(axes) and all(s >= 1 for s in shape), (
        shape, axes)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(axes), tuple(int(s) for s in shape), device)


def _refuse_model_parallel(model_parallel: int) -> None:
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: splitting kv heads over a "
            f"`model` axis {A13B}; one card serves model_parallel=1")


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 (or 2x16x16) production mesh: not on one card."""
    raise NotImplementedError(f"the production mesh {A13B}")


def make_local_mesh(axes=("data", "model"), device=None) -> Mesh:
    """Whatever devices of the chosen kind exist, as a (1, ..., n) mesh
    (the reference's mesh for tests and CPU entry points)."""
    device = resolve_device(device)
    n = _device_count(device)
    _refuse_model_parallel(n if len(axes) > 1 else 1)
    return _mesh((1,) * (len(axes) - 1) + (n,), axes, device)


def make_serving_mesh(n_hosts: Optional[int] = None,
                      model_parallel: int = 1, device=None) -> Mesh:
    """Serving-pool mesh: one ``data`` shard per simulated host, ``model``
    fixed at ``model_parallel``.  ``n_hosts`` defaults to the device
    count of the chosen kind (as the reference's defaults to
    ``jax.device_count()``); every host shard lives on ``device``."""
    device = resolve_device(device)
    _refuse_model_parallel(model_parallel)
    if n_hosts is None:
        n_hosts = _device_count(device) // model_parallel
    return _mesh((n_hosts, model_parallel), ("data", "model"), device)


def make_elastic_mesh(n_devices: int, axes=("data", "model"),
                      model_parallel: int = 1, device=None) -> Mesh:
    """Rebuild a mesh after a world-size change (a host lost or added):
    ``model_parallel`` stays fixed and the rest goes to ``data``."""
    assert n_devices % model_parallel == 0
    _refuse_model_parallel(model_parallel)
    return _mesh((n_devices // model_parallel, model_parallel), axes[-2:],
                 resolve_device(device))
