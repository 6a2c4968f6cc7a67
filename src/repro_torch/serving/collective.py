"""The physical exchange of ``control.CollectiveTransport``: on one device
(``DeviceGather``) or across rank processes (``RankGather``).

The transport's protocol (padding, rounds, visibility, the digest row)
is device-free in serving/control.py; this module supplies only the
exchange.  Its input is the stacked outbox ``(n_hosts, capacity + 1,
DELTA_FIELDS)`` int32 (the last row of each host's slice carrying its
replicated-state digest), its output every host's received view
``(n_hosts, n_hosts, capacity + 1, DELTA_FIELDS)``, which the transport
asserts identical.  The buffers' shape is static, so no traffic or fault
changes it.

* ``DeviceGather`` (a mesh on one device, hosts simulated as data shards
  of one pool): each host's row is committed to its own buffer on the
  mesh's device and each host's view gathered there from those buffers,
  one gather per host, so that the replica assert checks what the device
  produced, not a host-side broadcast.
* ``RankGather`` (a mesh over a world of ranks, one data shard's slot
  rows on its own ranks): each rank puts only its own host's row into an
  all-gather over ``data`` (through ``mesh.transport``: gloo, a CUDA
  tensor staged through the host, or nccl), checks that the rows it
  received for the other hosts equal its own replicated outbox for them
  (``ReplicaDivergence`` otherwise), and gathers the received views over
  ``data``, so the transport's replica assert compares views that
  different ranks received.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.control import ReplicaDivergence


class DeviceGather:
    """``(n_hosts, C, F)`` int32 outbox stack -> every host's view
    ``(n_hosts, n_hosts, C, F)``, gathered on ``mesh.device``.

    ``commit`` writes host h's row into ``buffers[h]``; ``exchange``
    gathers each host's view from the buffers into ``views[h]`` and
    copies the views back once.  ``rounds`` counts the exchanges."""

    def __init__(self, mesh, data_axis: str = "data"):
        self.n_hosts = int(mesh.shape[data_axis])
        self.device = mesh.device
        self.buffers = None
        self.views = None
        self.rounds = 0

    def commit(self, buf: np.ndarray) -> None:
        assert buf.shape[0] == self.n_hosts, (buf.shape, self.n_hosts)
        if self.buffers is None or self.buffers[0].shape != buf.shape[1:]:
            self.buffers = [torch.empty(buf.shape[1:], dtype=torch.int32,
                                        device=self.device)
                            for _ in range(self.n_hosts)]
            self.views = torch.empty((self.n_hosts,) + buf.shape,
                                     dtype=torch.int32, device=self.device)
        rows = torch.from_numpy(np.ascontiguousarray(buf, np.int32))
        for h in range(self.n_hosts):
            self.buffers[h].copy_(rows[h])

    def exchange(self) -> np.ndarray:
        for h in range(self.n_hosts):
            torch.stack(self.buffers, out=self.views[h])
        self.rounds += 1
        return self.views.cpu().numpy()

    def __call__(self, buf: np.ndarray) -> np.ndarray:
        self.commit(buf)
        return self.exchange()


def check_received(own: np.ndarray, received: np.ndarray, host: int,
                   rounds: int) -> None:
    """Raise ``ReplicaDivergence`` unless the rows that the rank of
    ``host`` received from the other hosts (``received`` (n_hosts, C, F))
    equal its own replicated outbox for them (``own``)."""
    bad = [g for g in range(own.shape[0])
           if g != host and not np.array_equal(received[g], own[g])]
    if bad:
        raise ReplicaDivergence(
            f"exchange round {rounds}: the rank of host {host} received "
            f"rows for hosts {bad} that differ from its own replicated "
            "outbox")


class RankGather:
    """The exchange across rank processes: ``(n_hosts, C, F)`` int32
    outbox stack (every rank computes all of it: the control plane is
    replicated) -> every host's view ``(n_hosts, n_hosts, C, F)``, each
    received by another rank.

    A round is two all-gathers over ``mesh``'s ``data`` group: this
    rank's own host's row (the delta exchange), then its received view
    (the views for the replica assert).  ``rounds`` counts the rounds."""

    def __init__(self, mesh, data_axis: str = "data"):
        if not mesh.distributed:
            raise ValueError("RankGather takes a mesh over a world of "
                             "ranks (DeviceGather: one device)")
        self.n_hosts = int(mesh.shape[data_axis])
        self.host = int(mesh.coords[data_axis])
        self.device = mesh.device
        self.transport = mesh.transport
        self.group = mesh.groups[data_axis]
        self.rounds = 0

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        parts = self.transport.all_gather(t.to(self.device), self.group)
        return torch.stack(parts).cpu().numpy()

    def __call__(self, buf: np.ndarray) -> np.ndarray:
        buf = np.ascontiguousarray(buf, np.int32)
        assert buf.shape[0] == self.n_hosts, (buf.shape, self.n_hosts)
        received = self._gather(torch.from_numpy(buf[self.host]))
        check_received(buf, received, self.host, self.rounds)
        views = self._gather(torch.from_numpy(received))
        self.rounds += 1
        return views


def make_device_gather(mesh, data_axis: str = "data"):
    """mesh -> gather fn for ``CollectiveTransport(gather=...)``: a
    ``RankGather`` over a world of ranks, else a ``DeviceGather``."""
    if mesh.distributed:
        return RankGather(mesh, data_axis)
    return DeviceGather(mesh, data_axis)
