"""Sharding rules: where every parameter, batch input, decode cache and
optimizer-state leaf sits on a mesh, and the functions that move a model's
tensors to and from their shards.

A ``PartitionSpec`` here is the reference's: one entry per axis of a
leaf, the mesh axes that axis shards over (``None``: not sharded).  The
rules are the reference's (``src/repro/launch/sharding.py``), evaluated on
its path names: ``_param_rules`` is its ordered regex table, and the
port's module names map to those paths through
``models.transformer.reference_path``, the same table that
``lm_params_from_jax`` and ``encdec_params_from_jax`` load by.  The
reference stacks its blocks under a leading layer axis, whose entry is
always ``None``; the port's per-layer modules have no such axis, so each
port spec is the reference's without that leading entry.

Conventions (the reference's DESIGN.md §6): the batch axes are every mesh
axis but ``model`` (pure data parallelism); ``model`` is Megatron-style
tensor parallelism (heads, d_ff, the vocab's m rows, experts, Mamba's
d_inner and heads); GQA kv heads replicate when ``num_kv_heads`` does not
divide the model axis; decode caches shard the batch over the batch axes
when it divides, else the sequence.  A cache whose sequence splits is
read by attention slice by slice: ``DistContext.cache_specs`` (set by
``decode_dist``) carries the caches' specs into model code, and
``seq_shard`` gives a rank its slice by the same ``_shard_index`` that
``local_shard`` cuts by.

On a mesh over a world of ranks (launch/mesh.py) each rank holds the
local shard of each leaf (``local_shard``, ``shard_state_dict``,
``shard_module``); ``gather_state_dict`` / ``gather_tree`` put the full
tensors back together through all-gathers.  The serving pool's specs
(``slot_pool_pspecs``) state which rows of a leaf each ``data`` shard
(host) owns, and which kv heads, Mamba heads and channels each ``model``
rank holds: over a world each rank holds its local shard of them; on the
port's one-device serving mesh they place no memory, and
``launch/steps.make_sharded_insert`` / ``make_compact_pool`` write only
the owning shard's rows.  ZeRO-1 (``opt_state_pspecs``'s ``zero_dist``) shards each
moment over the batch axes too, on a dim that its param's spec leaves
whole (``zero_dim`` picks it); ``shard_tree`` / ``gather_tree`` carry
such a moment like any other leaf, its batch axes one entry (a tuple on
a mesh of several batch axes, gathered over the ``batch`` group), and
``launch/steps.make_train_step(zero=True)`` runs the update on each
rank's slice.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import reference_path


class PartitionSpec(tuple):
    """Per-axis mesh axes of one leaf (``P("data", None)``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass
class DistContext:
    """Carries the mesh and the axis conventions into model code: the
    batch axes are every mesh axis but ``model``."""

    mesh: Mesh
    model_axis: str = "model"
    # whether the rows the model sees are this rank's shard of the global
    # batch (False: every rank holds the whole batch, as a prefill whose
    # batch does not divide the batch axes does)
    rows_split: bool = True
    # the decode caches' specs, per layer and leaf (``decode_dist``):
    # where a cache's sequence splits, attention reads it slice by slice
    cache_specs: Optional[List[Dict[str, "PartitionSpec"]]] = None

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

    @property
    def model_index(self) -> int:
        """This rank's coordinate on the model axis."""
        return self.mesh.coords.get(self.model_axis, 0)

    @property
    def batch_index(self) -> int:
        """This rank's index along the batch axes, row-major: the shard
        of the global batch that ``local_batch`` gives it."""
        return _shard_index(self.batch_axes, self.mesh)[1]

    @property
    def model_group(self):
        return self.mesh.groups[self.model_axis]

    @property
    def batch_group(self):
        return self.mesh.groups["batch"]

    def batch_spec_axes(self, b: int):
        """Batch-dim axes if ``b`` divides across them, else None
        (replicate)."""
        return self.batch_axes if b % self.n_batch == 0 else None

    def seq_shard(self, layer: int, key: str) -> Optional["SeqShard"]:
        """This rank's slice of the sequence of layer ``layer``'s cache
        leaf ``key`` ("k", "cross_k") when ``cache_specs`` split it, else
        None."""
        if self.cache_specs is None:
            return None
        entry = self.cache_specs[layer][key][1]
        n, i = _shard_index(entry, self.mesh)
        if n == 1:
            return None
        return SeqShard(i, _group_of(entry, self.mesh))


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A rank's slice of a cache's sequence: slice ``index`` of equal ones
    (positions ``[index * T, (index + 1) * T)`` of a local length T), the
    other slices held by the ranks of ``group``."""
    index: int
    group: object


# --------------------------------------------------------------------------
# Parameter partition specs
# --------------------------------------------------------------------------

def _param_rules(cfg: ModelConfig, n_model: int):
    """Ordered (regex, builder) table; builder(leaf_ndim) -> PartitionSpec."""
    kv_shardable = cfg.num_kv_heads % n_model == 0
    heads_shardable = cfg.num_heads % n_model == 0
    kv_ax = "model" if kv_shardable else None
    q_ax = "model" if heads_shardable else None
    mamba_ok = (cfg.mamba is not None
                and (cfg.mamba.expand * cfg.d_model
                     // cfg.mamba.head_dim) % n_model == 0)
    m_ax = "model" if mamba_ok else None
    vocab_ok = cfg.m_vocab % n_model == 0
    v_ax = "model" if vocab_ok else None
    moe_ok = cfg.moe is not None and cfg.moe.num_experts % n_model == 0
    e_ax = "model" if moe_ok else None
    ff_ok = cfg.d_ff % n_model == 0
    f_ax = "model" if ff_ok else None
    fe_ok = cfg.moe is not None and cfg.moe.d_ff_expert % n_model == 0
    fe_ax = "model" if fe_ok else None

    return [
        (r"io/embed$", lambda nd: P(v_ax, None)),
        (r"io/head$", lambda nd: P(None, v_ax)),
        (r"frontend_proj", lambda nd: P(*([None] * nd))),
        (r"attn/wq$", lambda nd: P(None, q_ax, None)),
        (r"(attn|self_attn|cross_attn)/w[kv]$",
         lambda nd: P(None, kv_ax, None)),
        (r"(self_attn|cross_attn)/wq$", lambda nd: P(None, q_ax, None)),
        (r"(attn|self_attn|cross_attn)/wo$",
         lambda nd: P(q_ax, None, None)),
        (r"attn/bq$|(self|cross)_attn/bq$", lambda nd: P(q_ax, None)),
        (r"b[kv]$", lambda nd: P(kv_ax, None)),
        (r"(q|k)_norm/scale$", lambda nd: P(None)),
        # FFN: 2D = dense SwiGLU (shard d_ff); 3D = expert-stacked MoE
        (r"ffn/router$", lambda nd: P(None, None)),
        (r"ffn/(w_gate|w_up)$", lambda nd: P(None, f_ax) if nd == 2
         else P(e_ax, None, None)),
        (r"ffn/w_down$", lambda nd: P(f_ax, None) if nd == 2
         else P(e_ax, None, None)),
        (r"shared/w_(gate|up)$", lambda nd: P(None, fe_ax)),
        (r"shared/w_down$", lambda nd: P(fe_ax, None)),
        # mamba
        (r"mamba/(z|x)_proj$", lambda nd: P(None, m_ax)),
        (r"mamba/dt_proj$", lambda nd: P(None, m_ax)),
        (r"mamba/(b|c)_proj$", lambda nd: P(None, None)),
        (r"mamba/conv_x/w$", lambda nd: P(None, m_ax)),
        (r"mamba/conv_x/b$", lambda nd: P(m_ax)),
        (r"mamba/conv_[bc]/", lambda nd: P(*([None] * nd))),
        (r"mamba/(A_log|D|dt_bias)$", lambda nd: P(m_ax)),
        (r"mamba/norm/scale$", lambda nd: P(m_ax)),
        (r"mamba/out_proj$", lambda nd: P(m_ax, None)),
        # rnn / recommender dense layers
        (r"cell/|in_proj|l\d+/", lambda nd: P(*([None] * nd))),
        # norms & everything residual-dim shaped
        (r"norm", lambda nd: P(*([None] * nd))),
        (r"", lambda nd: P(*([None] * nd))),   # fallback: replicate
    ]


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_pspecs(cfg: ModelConfig, params, dist) -> Dict[str, P]:
    """{name: PartitionSpec} for a model's params (a module, or a mapping
    of name to tensor, on any device, ``meta`` included): the reference's
    rule for the param's reference path, without the stacked layer axis.
    Only ``dist.n_model`` is read."""
    rules = _param_rules(cfg, dist.n_model)
    specs = {}
    for name, leaf in _named(params).items():
        s, _ = reference_path(name, cfg)
        nd = leaf.dim()
        spec = next(b(nd) for pat, b in rules if re.search(pat, s))
        specs[name] = P(*(list(spec) + [None] * nd)[:nd])
    return specs


def model_sharded(specs: Mapping[str, P]) -> set:
    """The names whose spec shards some axis over ``model``."""
    return {n for n, s in specs.items() if "model" in s}


# --------------------------------------------------------------------------
# Input / cache partition specs
# --------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
                 dist: DistContext) -> Dict[str, P]:
    """Each input's leading (batch) axis over the batch axes when it
    divides, else replicated."""
    return {k: P(dist.batch_spec_axes(v.shape[0]), *([None] * (v.dim() - 1)))
            for k, v in batch.items()}


# the reference's cache leaf names of the port's per-layer cache keys
_CACHE_PATHS = {"k": "attn/k", "v": "attn/v", "cross_k": "cross/k",
                "cross_v": "cross/v"}


def cache_pspecs(cfg: ModelConfig, caches: List[Dict[str, torch.Tensor]],
                 dist: DistContext, global_batch: int
                 ) -> List[Dict[str, P]]:
    """Decode-cache specs, per layer and leaf, for the port's per-layer
    caches ({"k", "v"} (B, T, KV, hd), the encoder-decoder's cross k/v, the
    Mamba {"ssm", "conv_*"}), the reference's rules:

      * kv heads shard over ``model`` when divisible;
      * otherwise, when no head dim can shard at all, the cache SEQUENCE
        dim shards over ``model``;
      * batch shards over the batch axes when divisible, else (long_500k
        B=1) the sequence additionally shards over the batch axes.
    """
    bx = dist.batch_spec_axes(global_batch)
    kv_ax = "model" if cfg.num_kv_heads % dist.n_model == 0 else None
    mamba_ok = (cfg.mamba is not None
                and (cfg.mamba.expand * cfg.d_model
                     // cfg.mamba.head_dim) % dist.n_model == 0)
    m_ax = "model" if mamba_ok else None
    heads_shardable = cfg.num_heads % dist.n_model == 0
    allow_seq_model = kv_ax is None and not heads_shardable

    def seq_axes_for(seq_len: int):
        axes = []
        if bx is None and seq_len % dist.n_batch == 0:
            axes.extend(dist.batch_axes)
        if allow_seq_model:
            n = dist.n_model
            total = math.prod(dist.mesh.shape[a] for a in axes) * n
            if seq_len % total == 0:
                axes.append(dist.model_axis)
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def spec_for(key: str, leaf: torch.Tensor) -> P:
        s = _CACHE_PATHS.get(key, key)
        if "attn" in s or "cross" in s:   # (B, T, KV, hd)
            return P(bx, seq_axes_for(leaf.shape[1]), kv_ax, None)
        if "ssm" in s:                    # (B, H, N, P)
            return P(bx, m_ax, None, None)
        if "conv_x" in s:                 # (B, d_conv-1, d_in)
            return P(bx, None, m_ax)
        if "conv_" in s:                  # gn channels: replicated
            return P(bx, None, None)
        return P(*([None] * leaf.dim()))

    return [{k: spec_for(k, v) for k, v in layer.items()} for layer in caches]


def shard_caches(cfg: ModelConfig, caches: List[Dict[str, torch.Tensor]],
                 dist: DistContext, global_batch: int
                 ) -> List[Dict[str, torch.Tensor]]:
    """This rank's shards (``cache_pspecs``) of the decode caches of a
    ``global_batch``-row batch (``meta`` in, ``meta`` out)."""
    specs = cache_pspecs(cfg, caches, dist, global_batch)
    return [{k: local_shard(v, s[k], dist.mesh) for k, v in layer.items()}
            for layer, s in zip(caches, specs)]


def decode_dist(cfg: ModelConfig, caches: List[Dict[str, torch.Tensor]],
                dist: DistContext, global_batch: int) -> DistContext:
    """``dist`` carrying the ``cache_pspecs`` of the (global) decode caches
    ``caches`` of a ``global_batch``-row batch, which the decode step
    reads them by (a split sequence, ``DistContext.seq_shard``)."""
    return dataclasses.replace(
        dist, cache_specs=cache_pspecs(cfg, caches, dist, global_batch))


def slot_pool_pspecs(pool: List[Dict], dist: DistContext, n_slots: int,
                     cfg: Optional[ModelConfig] = None
                     ) -> List[Dict[str, PartitionSpec]]:
    """The serving slot pool's specs, leaf by leaf: the reference's rule
    (``src/repro/launch/sharding.py`` ``slot_pool_pspecs``) with the SLOT
    axis first (the reference stacks layers ahead of it, ``(L, n_slots,
    ...)``).

    The port's pool is ``transformer.init_lm_cache``'s list of per-layer
    dicts.  Every leaf shards its slot axis over the data axes: data
    shard h owns the contiguous rows ``[h * n_slots // n_batch, (h + 1) *
    ...)``, so a cache insert touches exactly one shard.  The sequence
    axis never shards (an insert writes a slot-local ``[0, S_p)`` block).
    Under a ``model`` axis of more than one (``cfg`` then required):

      * attention and cross ``k`` / ``v`` (n_slots, T, KV, hd): kv heads
        over ``model`` when ``num_kv_heads`` divides it;
      * ``ssm`` (n_slots, H, N, P): heads over ``model`` when the Mamba
        heads ``expand * d_model // head_dim`` divide it;
      * ``conv_x`` (n_slots, d_conv - 1, d_in): channels over ``model``
        under the same condition;
      * every other leaf (``conv_b`` / ``conv_c``): the slot axis only.

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
    kv_ax = m_ax = None
    if dist.n_model > 1:
        if cfg is None:
            raise ValueError("a pool under a model axis splits by the "
                             "config's heads: pass cfg")
        if cfg.num_kv_heads % dist.n_model == 0:
            kv_ax = dist.model_axis
        if cfg.mamba is not None and (cfg.mamba.expand * cfg.d_model
                                      // cfg.mamba.head_dim
                                      ) % dist.n_model == 0:
            m_ax = dist.model_axis

    def spec_for(key: str, leaf) -> PartitionSpec:
        s = _CACHE_PATHS.get(key, key)
        if "attn" in s or "cross" in s:   # (n_slots, T, KV, hd)
            return P(bx, None, kv_ax, None)
        if "ssm" in s:                    # (n_slots, H, N, P)
            return P(bx, m_ax, None, None)
        if "conv_x" in s:                 # (n_slots, d_conv-1, d_in)
            return P(bx, None, m_ax)
        return P(bx, *([None] * (leaf.dim() - 1)))

    return [{name: spec_for(name, leaf) for name, leaf in layer.items()}
            for layer in pool]


def opt_state_pspecs(opt_state, params_specs: Mapping[str, P],
                     zero_dist: Optional[DistContext] = None,
                     params_shapes: Optional[Mapping[str, tuple]] = None):
    """Optimizer-state specs: a dict keyed by the param names mirrors the
    param specs (adafactor's per-param {"mu", "nu": {"vr", "vc"} or
    {"v"}}: mu the param's, vr / vc the param's without its last / second
    to last axis); counters and other leaves replicate.

    ZeRO-1 (``zero_dist`` with ``params_shapes``, name -> the param's
    full shape): each mirrored moment additionally shards over the batch
    axes on its first still-unsharded dim that they divide.  The port's
    leaves have no stacked layer axis, so where the reference would pick
    that axis (n_super divisible by the batch axes) the port picks the
    next.  Adafactor's factored moments and the counters stay as they
    are, as the reference's specs say."""
    names = set(params_specs)

    def zero_extend(spec, shape):
        if zero_dist is None or params_shapes is None:
            return spec
        dim = zero_dim(spec, shape, zero_dist.n_batch)
        return spec if dim is None else zero_spec(spec, dim, zero_dist)

    def factor(spec):
        parts = tuple(spec)
        if len(parts) >= 2:
            nu = {"vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
        else:
            nu = {"v": spec}
        return {"mu": spec, "nu": nu}

    def map_state(st):
        if isinstance(st, Mapping) and set(st) == names and names:
            if factored(st, names):
                return {n: factor(params_specs[n]) for n in st}
            return {n: zero_extend(params_specs[n],
                                   None if params_shapes is None
                                   else params_shapes[n]) for n in st}
        if isinstance(st, Mapping):
            return {k: map_state(v) for k, v in st.items()}
        if isinstance(st, (tuple, list)):
            return type(st)(map_state(v) for v in st)
        return P()

    return map_state(opt_state)


def zero_dim(spec: P, shape, n_batch: int) -> Optional[int]:
    """ZeRO-1's split of one param's moments: the first dim that ``spec``
    leaves whole and that ``n_batch`` shards divide, or None (the moments
    keep the param's spec).  ``shape`` may be the full leaf's or a rank's
    shard's: the two agree on every dim that the spec leaves whole."""
    for i, (dim, ax) in enumerate(zip(shape, spec)):
        if ax is None and dim % n_batch == 0 and dim >= n_batch:
            return i
    return None


def zero_spec(spec: P, dim: int, dist: DistContext) -> P:
    """``spec`` with the batch axes on ``dim`` (one entry, a tuple on a
    mesh of several batch axes)."""
    axes = dist.batch_axes
    parts = list(spec) + [None] * (dim + 1 - len(spec))
    parts[dim] = axes if len(axes) > 1 else axes[0]
    return P(*parts)


def factored(opt_state, names) -> bool:
    """Whether ``opt_state`` holds per-param dicts keyed by the param
    ``names`` (adafactor's factored moments), which ZeRO-1 leaves whole."""
    if isinstance(opt_state, Mapping):
        if names and set(opt_state) == set(names):
            return all(isinstance(v, Mapping) for v in opt_state.values())
        return any(factored(v, names) for v in opt_state.values())
    if isinstance(opt_state, (tuple, list)):
        return any(factored(v, names) for v in opt_state)
    return False


# --------------------------------------------------------------------------
# Moving tensors to and from their shards
# --------------------------------------------------------------------------

def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _shard_index(entry, mesh: Mesh) -> Tuple[int, int]:
    """(shards, this rank's index) along the mesh axes of one spec entry,
    row-major over the axes listed."""
    n, i = 1, 0
    for a in _axes_of(entry):
        n *= mesh.shape[a]
        i = i * mesh.shape[a] + mesh.coords[a]
    return n, i


def local_shard(tensor: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """The slice of ``tensor`` (the full leaf) that this rank owns under
    ``spec``: dim // shards rows of each sharded dim, a new contiguous
    tensor (``meta`` in, ``meta`` out)."""
    out = tensor
    for dim, entry in enumerate(spec):
        n, i = _shard_index(entry, mesh)
        if n == 1:
            continue
        size = tensor.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"divide into {n} shards ({spec})")
        out = out.narrow(dim, i * (size // n), size // n)
    return out.clone(memory_format=torch.contiguous_format)


def shard_state_dict(sd: Mapping[str, torch.Tensor],
                     specs: Mapping[str, P], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """Every leaf's local shard."""
    return {n: local_shard(t, specs[n], mesh) for n, t in sd.items()}


def _group_of(entry, mesh: Mesh):
    axes = _axes_of(entry)
    if len(axes) == 1:
        return mesh.groups[axes[0]]
    batch = tuple(a for a in mesh.axis_names if a != "model")
    if axes == batch:
        return mesh.groups["batch"]
    if axes == tuple(mesh.axis_names):
        return mesh.groups["world"]
    raise ValueError(f"no process group spans the axes {axes}")


def gather_leaf(local: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's local shard (all-gathers along
    each sharded dim, through the mesh's transport)."""
    out = local.detach()
    for dim, entry in enumerate(spec):
        if _shard_index(entry, mesh)[0] == 1:
            continue
        parts = mesh.transport.all_gather(out.contiguous(),
                                          _group_of(entry, mesh))
        out = torch.cat(parts, dim=dim)
    return out


def gather_state_dict(sd: Mapping[str, torch.Tensor],
                      specs: Mapping[str, P], mesh: Mesh
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: every leaf whole, on every
    rank."""
    return {n: gather_leaf(t, specs[n], mesh) for n, t in sd.items()}


def gather_tree(tree, specs, mesh: Mesh):
    """``gather_leaf`` over a nest of dicts and tuples whose specs are the
    same nest (``opt_state_pspecs``)."""
    if isinstance(tree, Mapping):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return gather_leaf(tree, specs, mesh)


def shard_tree(tree, specs, mesh: Mesh):
    """``local_shard`` over a nest of dicts and tuples (the inverse of
    ``gather_tree``)."""
    if isinstance(tree, Mapping):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return local_shard(tree, specs, mesh)


def shard_module(module: nn.Module, specs: Mapping[str, P],
                 mesh: Mesh) -> nn.Module:
    """Replace, in place, every parameter of ``module`` by its local shard
    (a new parameter of the shard's shape); returns ``module``."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[attr] = nn.Parameter(
            local_shard(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad)
    return module


def local_batch(batch: Mapping[str, torch.Tensor],
                dist: DistContext) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (``batch_pspecs``)."""
    specs = batch_pspecs(None, batch, dist)
    return {k: local_shard(v, specs[k], dist.mesh) for k, v in batch.items()}
