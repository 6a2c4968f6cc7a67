"""Config dataclasses of the token-LM path.

Copied from the JAX package's ``configs/base.py``: ``BloomConfig``,
``MoEConfig`` and ``MambaConfig`` whole; ``ModelConfig`` with the fields
every model family reads (the MoE FFN and its period, the Mamba-2 mixer,
the hybrid's attention period and offset, the encoder-decoder's
``encoder_layers`` and the stub frontend's ``frontend`` and
``frontend_frac``), its layer-role predicates and its ``param_count``;
and ``TrainConfig`` whole.  The execution knobs keep the reference's
defaults and meanings: ``remat`` (none|full|dots, the checkpoint policy
of each super-block in training, ``models/transformer.py``), ``attn_impl``
(chunked|naive), ``attn_chunk_q`` / ``attn_chunk_k`` (the flash-style
attention's q and kv block sizes), ``causal_skip`` (q chunks that scan
only the kv chunks up to their own end) and ``attn_bf16_scores`` (the
score chain in bf16, its softmax statistics f32; ``models/
attention.py``).  Left out: ``param_dtype``; ``io_impl`` (the port's IO
path follows the tensors' device: kernel on CUDA, plain version on the
CPU); ``scan_layers`` and ``unroll_for_analysis``, which size XLA's HLO
and its cost analysis (the port's layers are a Python loop, and its dry
run counts every op).  ``moe_impl`` picks the MoE path as in the
reference: "dense" (every expert on the rank, the single-device path) or
"ep" (expert parallelism over the mesh's ``model`` axis,
``models/moe.py``).  ``ShapeConfig``, the four ``SHAPES`` cells and
``MeshConfig`` (the production mesh's shape and axes) are copied whole.
``bwd_impl`` picks the Bloom embedding's backward, "csr" (the CSR
scatter-add) or "dense" (the dense m-tile sweep), as in the reference.
``table_dtype``, ``bwd_impl``, ``moe_impl`` and the execution knobs are
validated when the config is made: an unknown value raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import quant
from repro_torch.kernels.common import resolve_bwd_impl


MOE_IMPLS = ("dense", "ep")
REMATS = ("none", "full", "dots")
ATTN_IMPLS = ("chunked", "naive")


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """The paper's technique as a first-class IO-compression feature."""

    enabled: bool = False
    m_ratio: float = 0.2      # m/d compression (paper's sweet spot)
    k: int = 4                # hash projections (paper: 2 <= k <= 4 best)
    seed: int = 0
    on_the_fly: bool = True   # double-hash per call (no H matrix kept)

    def m_of(self, d: int) -> int:
        m = int(round(self.m_ratio * d))
        if m >= 512:
            # align to 256, as the reference does (its TPU lane multiples
            # and model-axis divisibility); kept so m equals the reference's
            m = (m // 256) * 256
        return max(self.k, min(m, d))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts (0 = dense FFN)
    top_k: int = 2
    num_shared: int = 0           # always-active shared experts
    d_ff_expert: int = 0          # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0             # 0 => d_model // num_heads
    qk_norm: bool = False         # qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False        # qwen1.5-style bias on QKV projections
    rope_theta: float = 10_000.0
    use_rope: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"       # activation/compute dtype
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1     # MoE FFN every Nth layer (jamba: 2)
    # --- SSM / hybrid ---
    mamba: Optional[MambaConfig] = None
    attn_layer_period: int = 0    # hybrid: 1 attn layer per N (jamba: 8)
    attn_layer_offset: int = 4    # index of the attn layer inside a period
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0       # >0 => enc-dec; decoder uses num_layers
    # --- modality frontend stubs ---
    frontend: str = "none"        # none|vision_stub|audio_stub
    frontend_frac: float = 0.25   # fraction of seq occupied by stub embeds
    # --- paper technique ---
    bloom: BloomConfig = dataclasses.field(default_factory=BloomConfig)
    table_dtype: str = "auto"     # Bloom table storage dtype: auto
                                  # (legacy: cast to `dtype`) | float32 |
                                  # bfloat16 | int8 (per-row scales) |
                                  # fp8_e4m3 — core.quant is the source
                                  # of truth; grads are straight-through
    bwd_impl: str = "csr"         # Bloom embedding backward: csr (CSR
                                  # scatter-add) | dense (m-tile sweep)
    moe_impl: str = "dense"       # dense (every expert local) | ep
                                  # (experts over the `model` axis)
    # --- execution knobs ---
    remat: str = "full"           # none|full|dots (checkpoint policy)
    attn_chunk_q: int = 2048      # chunked-attention block sizes
    attn_chunk_k: int = 1024
    attn_impl: str = "chunked"    # chunked|naive (oracle)
    causal_skip: bool = False     # triangular kv-chunk skipping
    attn_bf16_scores: bool = False  # bf16 score/prob chain (f32 softmax
                                    # stats kept)

    def __post_init__(self):
        quant.resolve_table_dtype(self.table_dtype, allow_auto=True)
        resolve_bwd_impl(self.bwd_impl)
        for name, allowed in (("moe_impl", MOE_IMPLS), ("remat", REMATS),
                              ("attn_impl", ATTN_IMPLS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        for name in ("attn_chunk_q", "attn_chunk_k"):
            n = getattr(self, name)
            if isinstance(n, bool) or not isinstance(n, int) or n < 1:
                raise ValueError(f"{name} must be a positive int, got "
                                 f"{n!r}")
        for name in ("causal_skip", "attn_bf16_scores"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be a bool, got "
                                 f"{getattr(self, name)!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_full_attention(self) -> bool:
        """True when context cost is quadratic => long_500k must be skipped."""
        return self.family not in ("ssm", "hybrid")

    @property
    def m_vocab(self) -> int:
        """Output/input IO dimensionality after (optional) Bloom compression."""
        return self.bloom.m_of(self.vocab) if self.bloom.enabled else self.vocab

    def param_count(self) -> int:
        """Analytic parameter count (embedding + backbone + head)."""
        D, F, V = self.d_model, self.d_ff, self.m_vocab
        hd = self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        dense_ffn = 3 * D * F  # SwiGLU
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        for li in range(self.num_layers):
            if self._layer_is_attention(li):
                n += attn
            elif self.mamba is not None:
                mc = self.mamba
                d_in = mc.expand * self.d_model
                nh = d_in // mc.head_dim
                # in_proj (z,x,B,C,dt) + conv + A,D + norm + out_proj
                n += D * (2 * d_in + 2 * mc.n_groups * mc.d_state + nh)
                n += (d_in + 2 * mc.n_groups * mc.d_state) * mc.d_conv
                n += 2 * nh + d_in
                n += d_in * D
            if self._layer_is_moe(li):
                mo = self.moe
                n += D * mo.num_experts  # router
                n += mo.num_experts * 3 * D * mo.d_ff_expert
                n += mo.num_shared * 3 * D * mo.d_ff_expert
            elif not (self.family == "ssm"):
                n += dense_ffn
            n += 2 * D  # two pre-norms
        n += D  # final norm
        if self.encoder_layers:
            n += self.encoder_layers * (attn + dense_ffn + 2 * D) + D
        return n

    def _layer_is_attention(self, li: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_layer_period > 0:  # hybrid
            return li % self.attn_layer_period == self.attn_layer_offset
        return True

    def _layer_is_moe(self, li: int) -> bool:
        return self.moe is not None and li % self.moe_layer_period == (
            self.moe_layer_period - 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-arch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train|prefill|decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    optimizer: str = "adam"       # adam|adamw|adafactor|adagrad|
                                  # rmsprop|sgd
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0
    grad_clip_norm: float = 1.0
    grad_compression: str = "none"  # none|bf16 (gradient round trip)
    microbatch: int = 0           # >0 => grad-accumulation chunks in
                                  # train.trainer.make_train_step; the
                                  # LM step (launch/steps.py) reads it
                                  # not, as in the reference
    steps: int = 100
    warmup_steps: int = 10
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self):
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod \
            else ("data", "model")
