"""Sharding rules, the part sharded serving needs: ``DistContext`` and the
slot pool's layout (``slot_pool_pspecs``).

A ``PartitionSpec`` here is the reference's: one entry per axis of a
leaf, the mesh axes that axis shards over (``None``: not sharded).  On
the port's one-device mesh (launch/mesh.py) a spec does not place
memory; it states which rows of a leaf each ``data`` shard (simulated
host) owns, and ``launch/steps.make_sharded_insert`` /
``make_compact_pool`` write only those rows.

The param, batch, cache and optimizer-state rules of the reference
(``sharding.py:110-260``, ``:320``) wait for ROADMAP A13b, with the
placement of shards on several cards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from repro_torch.launch.mesh import Mesh


class PartitionSpec(tuple):
    """Per-axis mesh axes of one leaf (``P("data", None)``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass
class DistContext:
    """Carries the mesh and the axis conventions: the batch axes are every
    mesh axis but ``model``."""

    mesh: Mesh
    model_axis: str = "model"

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.axis_names
                     if a != self.model_axis)

    @property
    def n_batch(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    @property
    def n_model(self) -> int:
        return self.mesh.shape.get(self.model_axis, 1)


def slot_pool_pspecs(pool: List[Dict], dist: DistContext,
                     n_slots: int) -> List[Dict[str, PartitionSpec]]:
    """The serving slot pool's specs, leaf by leaf.

    The port's pool is ``transformer.init_lm_cache``'s list of per-layer
    dicts with the SLOT axis first (the reference stacks layers ahead of
    it, ``(L, n_slots, ...)``).  Every leaf (attention and cross k/v,
    the Mamba ``ssm`` and ``conv_*``) shards its slot axis over the data
    axes: data shard h owns the contiguous rows ``[h * n_slots //
    n_batch, (h + 1) * ...)``, so a cache insert touches exactly one
    shard.  No other axis shards: the sequence axis never does (an
    insert writes a slot-local ``[0, S_p)`` block), and the reference's
    split of kv heads, ``ssm`` heads and ``conv_x`` channels over
    ``model`` waits for ROADMAP A13b with ``model`` axes of more than one
    (launch/mesh.py).

    ``n_slots`` must divide across the data axes: the per-host admission
    shards (serving/scheduler.ShardedScheduler) own equal contiguous
    slot ranges.
    """
    if n_slots % dist.n_batch:
        raise ValueError(
            f"n_slots={n_slots} must divide the data axes "
            f"(|data|={dist.n_batch}) — per-host admission shards own "
            "equal contiguous slot ranges")
    bx = dist.batch_axes if dist.n_batch > 1 else None
    return [{name: P(bx, *([None] * (leaf.dim() - 1)))
             for name, leaf in layer.items()}
            for layer in pool]
