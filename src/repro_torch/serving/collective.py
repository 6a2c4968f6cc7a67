"""Device gather for ``control.CollectiveTransport``.

The transport's protocol (padding, rounds, visibility, the digest row)
is device-free in serving/control.py; this module supplies only the
physical exchange.  Each host's fixed-size delta buffer is committed to
its own buffer on the mesh's device, and each host's received view is
gathered on the device from those buffers, one gather per host, so that
the transport's replica-agreement assert checks what the device
produced, not a host-side broadcast.

The buffers' shape is static (``(capacity + 1) x DELTA_FIELDS``, the
last row carrying the host's replicated-state digest), so no traffic or
fault changes it.  All hosts' buffers share the one device of the port's
mesh (launch/mesh.py); a multi-process ``all_gather_into_tensor`` over
several cards waits for ROADMAP A13b.
"""
from __future__ import annotations

import numpy as np
import torch


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


def make_device_gather(mesh, data_axis: str = "data") -> DeviceGather:
    """mesh -> gather fn for ``CollectiveTransport(gather=...)``."""
    return DeviceGather(mesh, data_axis)
