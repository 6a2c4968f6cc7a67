"""Config dataclasses of the token-LM path.

Copied from the JAX package's ``configs/base.py``: ``BloomConfig`` and
``ModelConfig`` with the fields the dense decoder-only family reads, and
``TrainConfig`` whole.  Left out: the MoE, Mamba, hybrid, encoder-decoder
and frontend fields and ``param_dtype`` (a ``family`` other than
``"dense"`` raises where a model is built, ROADMAP A12); ``io_impl`` (the
port's IO path follows the tensors' device: kernel on CUDA, plain version
on the CPU); the XLA execution knobs (``scan_layers``, ``remat``,
``attn_chunk_*``, ``attn_impl``, ``causal_skip``, ``attn_bf16_scores``,
``moe_impl``, ``unroll_for_analysis``); and the shape and mesh configs,
which no ported module reads.  ``bwd_impl`` picks the Bloom embedding's
backward, "csr" (the CSR scatter-add) or "dense" (the dense m-tile
sweep), as in the reference.  ``table_dtype`` and ``bwd_impl`` are
validated when the config is made: an unknown value raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import quant
from repro_torch.kernels.common import resolve_bwd_impl


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
    # --- paper technique ---
    bloom: BloomConfig = dataclasses.field(default_factory=BloomConfig)
    table_dtype: str = "auto"     # Bloom table storage dtype: auto
                                  # (legacy: cast to `dtype`) | float32 |
                                  # bfloat16 | int8 (per-row scales) |
                                  # fp8_e4m3 — core.quant is the source
                                  # of truth; grads are straight-through
    bwd_impl: str = "csr"         # Bloom embedding backward: csr (CSR
                                  # scatter-add) | dense (m-tile sweep)

    def __post_init__(self):
        quant.resolve_table_dtype(self.table_dtype, allow_auto=True)
        resolve_bwd_impl(self.bwd_impl)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def m_vocab(self) -> int:
        """Output/input IO dimensionality after (optional) Bloom compression."""
        return self.bloom.m_of(self.vocab) if self.bloom.enabled else self.vocab

    def param_count(self) -> int:
        """Analytic parameter count (embedding + backbone + head) of the
        dense decoder-only family, the one the port serves."""
        D, F, V = self.d_model, self.d_ff, self.m_vocab
        hd = self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        dense_ffn = 3 * D * F  # SwiGLU
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        n += self.num_layers * (attn + dense_ffn + 2 * D)  # + two pre-norms
        return n + D  # final norm


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
