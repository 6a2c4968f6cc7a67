"""The transport of the parallel training step and the collectives it calls.

The JAX package has no counterpart: it places each leaf by its
PartitionSpec and lets XLA insert the collectives (GSPMD), adding only
the expert-parallel ``shard_map``'s psum.  The port's kernels are called
through ``ctypes`` (kernels/common.py), which no partitioner can see
into, so the step holds each rank's local shard (launch/sharding.py) and
calls the collectives itself, Megatron-style:

* ``copy_to_model``: identity forward, all-reduce over ``model``
  backward, where a replicated activation (or a replicated parameter)
  enters a region that each ``model`` rank computes only part of (its
  heads, its d_ff columns, its experts, its vocab rows);
* ``reduce_from_model``: all-reduce over ``model`` forward, identity
  backward, where the parts are summed (a row-parallel product's
  output, the vocab-parallel embedding);
* ``all_reduce_model``: all-reduce over ``model`` both ways, where every
  rank's part depends on the sum (the gated RMSNorm's sum of squares
  over a Mamba mixer's split channels);
* ``all_gather`` along an axis (not differentiated: the vocab-parallel
  loss's local lse, a checkpoint's shards);
* ``softmax_combine``: attention over a cache whose sequence is split,
  one all-gather of each slice's (max, sum, weighted values), merged on
  every rank (``merge_softmax``; not differentiated: decode only);
* ``data_mean``: the gradient mean over the batch axes.

Low-precision tensors (bf16, f16) are summed in f32 and rounded back once.

Every collective goes through a ``Transport`` that the caller names,
``gloo`` or ``nccl`` (``--transport``); nothing switches from one to the
other.  ``nccl`` needs a card per rank (``init_world`` raises otherwise).
``gloo`` takes CUDA tensors for ``all_reduce`` and ``broadcast``; it has
no CUDA ``all_gather``, so the gloo transport stages that one call
through the host: a copy to the CPU, the gather there, a copy back.  The
transport counts which branch each collective took (``branches``:
("all_reduce", "device") and so on), and with ``timed`` it synchronises
the device around each call and adds up the seconds spent in them by
collective (``op_seconds``; ``seconds`` is their sum).
Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: gloo has
no ``reduce_scatter``.

The dry run (launch/dryrun.py) stands in for one rank of a world that
does not exist: its mesh's groups are ``CountedGroup``s (a size, no
ranks) and its transport a ``CountingTransport``, which records each
call's kind, result and operand bytes and group size and returns a
result of the right shape without communicating.  It is not one of
``TRANSPORTS``: nothing but the dry run builds it.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

TRANSPORTS = ("gloo", "nccl")
# the collectives gloo runs on CUDA tensors' own buffers
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "broadcast"})
TIMEOUT = datetime.timedelta(seconds=300)


class Transport:
    """The named backend of a world's collectives, with the branch each
    call took and (``timed``) the seconds spent in them by collective
    (``op_seconds``), in all (``seconds``)."""

    def __init__(self, name: str):
        if name not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{name!r}")
        self.name = name
        self.branches: collections.Counter = collections.Counter()
        self.timed = False
        self.op_seconds: collections.Counter = collections.Counter()

    @property
    def seconds(self) -> float:
        """The seconds spent in every timed collective together."""
        return sum(self.op_seconds.values())

    def branch(self, op: str, t: torch.Tensor) -> str:
        """``device`` (the tensor's own buffer), ``host`` (gloo's staged
        copy of a CUDA tensor) or ``cpu`` (a CPU tensor)."""
        if not t.is_cuda:
            return "cpu"
        if self.name == "gloo" and op not in GLOO_CUDA_NATIVE:
            return "host"
        return "device"

    def _run(self, op: str, t: torch.Tensor, fn):
        b = self.branch(op, t)
        self.branches[(op, b)] += 1
        if not self.timed:
            return fn(b)
        if t.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(b)
        if t.is_cuda:
            torch.cuda.synchronize()
        self.op_seconds[op] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """Sum ``t`` over ``group`` in place; returns it."""
        self._run("all_reduce", t,
                  lambda b: dist.all_reduce(t, group=group))
        return t

    def broadcast(self, t: torch.Tensor, src: int, group=None
                  ) -> torch.Tensor:
        """``t`` of global rank ``src`` into every rank's ``t``, in
        place; returns it."""
        self._run("broadcast", t,
                  lambda b: dist.broadcast(t, src=src, group=group))
        return t

    def all_gather(self, t: torch.Tensor, group) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape), in the group's rank order."""
        def gather(b):
            src = t.cpu() if b == "host" else t.contiguous()
            parts = [torch.empty_like(src)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, src, group=group)
            return [p.to(t.device) for p in parts] if b == "host" else parts
        return self._run("all_gather", t, gather)


@dataclasses.dataclass(frozen=True)
class CountedGroup:
    """A process group of the dry run's mesh: its size, no ranks."""
    size: int


class CountingTransport:
    """The dry run's transport: each call is recorded in ``calls`` as
    {"kind", "result_bytes", "operand_bytes", "group"} (the reference's
    HLO names: ``all-reduce``, ``all-gather``) and answered with a tensor
    of the result's shape and no exchange (``all_reduce`` leaves ``t`` as
    it is).  ``launch/roofline.ring_collectives`` reads ``calls``."""

    name = "counting"

    def __init__(self):
        self.calls: List[Dict] = []

    def _record(self, kind: str, result: int, operand: int, group) -> None:
        self.calls.append({"kind": kind, "result_bytes": result,
                           "operand_bytes": operand, "group": group.size})

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        n = t.numel() * t.element_size()
        self._record("all-reduce", n, n, group)
        return t

    def all_gather(self, t: torch.Tensor, group) -> List[torch.Tensor]:
        n = t.numel() * t.element_size()
        self._record("all-gather", n * group.size, n, group)
        return [torch.empty_like(t) for _ in range(group.size)]

    def broadcast(self, t, src, group=None):
        raise NotImplementedError("the dry run counts a step, which "
                                  "broadcasts nothing")


def init_world(rank: int, world: int, init_method: str, transport: str,
               device_type: str) -> torch.device:
    """Join the world of ``world`` ranks as ``rank`` over ``transport``
    (``init_method`` e.g. ``tcp://localhost:<port>``); returns the rank's
    device.  On CUDA, ``gloo`` puts every rank on card 0 (the ranks share
    one card), ``nccl`` puts rank r on card r and raises when there are
    fewer cards than ranks.  ``device_type`` "cpu" runs on the CPU
    (gloo only)."""
    Transport(transport)     # validates the name
    if device_type == "cpu":
        if transport != "gloo":
            raise ValueError("the CPU world runs over gloo")
        device = torch.device("cpu")
    elif transport == "nccl":
        n = torch.cuda.device_count()
        if n < world:
            raise RuntimeError(
                f"nccl needs a card per rank: {world} ranks, {n} cards "
                "(ranks sharing one card exchange over gloo)")
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(transport, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return device


# --------------------------------------------------------------------------
# The collectives of the step (``dist`` is launch/sharding.DistContext)
# --------------------------------------------------------------------------

def _sum(t: torch.Tensor, dist_ctx, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group`` (low precision in f32)."""
    wide = (torch.float32 if t.dtype in (torch.bfloat16, torch.float16)
            else t.dtype)
    acc = t.to(wide, copy=True, memory_format=torch.contiguous_format)
    dist_ctx.mesh.transport.all_reduce(acc, group)
    return acc.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist_ctx):
        ctx.dist_ctx = dist_ctx
        return x

    @staticmethod
    def backward(ctx, g):
        d = ctx.dist_ctx
        return _sum(g, d, d.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist_ctx):
        return _sum(x, dist_ctx, dist_ctx.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist_ctx):
        ctx.dist_ctx = dist_ctx
        return _sum(x, dist_ctx, dist_ctx.model_group)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dist_ctx
        return _sum(g, d, d.model_group), None


def copy_to_model(x: torch.Tensor, dist_ctx) -> torch.Tensor:
    """Identity; its gradient is summed over ``model``.  A no-op without
    a model axis of more than one."""
    if dist_ctx is None or dist_ctx.n_model == 1:
        return x
    return _CopyToModel.apply(x, dist_ctx)


def reduce_from_model(x: torch.Tensor, dist_ctx) -> torch.Tensor:
    """``x`` summed over ``model``; its gradient passes as it is."""
    if dist_ctx is None or dist_ctx.n_model == 1:
        return x
    return _ReduceFromModel.apply(x, dist_ctx)


def all_reduce_model(x: torch.Tensor, dist_ctx) -> torch.Tensor:
    """``x`` summed over ``model``, and its gradient summed over ``model``
    too: each rank's part of the result's use differs, so the gradient of
    the sum is every rank's.  A no-op without a model axis of more than
    one."""
    if dist_ctx is None or dist_ctx.n_model == 1:
        return x
    return _AllReduceModel.apply(x, dist_ctx)


def merge_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor
                  ) -> torch.Tensor:
    """Softmax attention from the partials of n slices of the keys,
    stacked on a leading axis: m (n, ...) each slice's largest score
    (-inf: no valid key in it), l (n, ...) its sum of exp(s - m) and o
    (n, ..., hd) its sum of exp(s - m) v.  Returns
    sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r (..., hd), M the largest
    m: a slice with no valid key weighs 0."""
    top = m.amax(0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(m - top)
    return (w[..., None] * o).sum(0) / (w * l).sum(0)[..., None]


def softmax_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    dist_ctx, group) -> torch.Tensor:
    """``merge_softmax`` of this rank's partials (m, l (...), o (..., hd))
    and those of the other ranks of ``group``, which hold the other
    slices of the keys: one all-gather of the three packed in f32."""
    packed = torch.cat([m[..., None], l[..., None], o], -1).float()
    parts = torch.stack(dist_ctx.mesh.transport.all_gather(
        packed.contiguous(), group))
    return merge_softmax(parts[..., 0], parts[..., 1], parts[..., 2:])


def all_gather(x: torch.Tensor, dist_ctx, axis: str = "model"
               ) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis`` ("model" or "batch"), in the
    axis's order (not differentiated)."""
    group = dist_ctx.model_group if axis == "model" else dist_ctx.batch_group
    return dist_ctx.mesh.transport.all_gather(x.detach(), group)


def all_reduce_sum(x: torch.Tensor, dist_ctx, axis: str = "model"
                   ) -> torch.Tensor:
    """A new tensor: ``x`` summed along ``axis`` ("model" or "batch"),
    not differentiated."""
    group = dist_ctx.model_group if axis == "model" else dist_ctx.batch_group
    return _sum(x.detach(), dist_ctx, group)


def data_mean(grads: Dict[str, torch.Tensor], dist_ctx,
              compress: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The gradients averaged over the batch axes, in one all-reduce of a
    flat f32 buffer.  ``compress="bf16"`` rounds each gradient to bf16
    before the all-reduce (the reference's DP all-reduce compression)."""
    if dist_ctx is None or dist_ctx.n_batch == 1:
        return grads
    names = list(grads)
    flat = torch.cat([(grads[n].to(torch.bfloat16) if compress == "bf16"
                       else grads[n]).float().reshape(-1) for n in names])
    dist_ctx.mesh.transport.all_reduce(flat, dist_ctx.batch_group)
    flat /= dist_ctx.n_batch
    out, i = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[i:i + g.numel()].view(g.shape).to(g.dtype)
        i += g.numel()
    return out
