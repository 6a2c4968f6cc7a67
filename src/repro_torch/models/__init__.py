"""Models: layers, the recommender tower, the IO boundary and the decoder
LMs (dense, MoE, SSM, hybrid).

  layers       — initialisers, dense layer, RMSNorm, RoPE, SwiGLU
  recommender  — the paper's feed-forward tower (FFTower), also a classifier
  rnn          — the GRU / LSTM session models (RNNLM)
  io           — Bloom / dense token embedding, LM head, Eq. 3 recovery
  attention    — decoder self-attention (prefill + slot decode)
  moe          — the MoE FFN: top-k routing into capacity buffers
  mamba2       — the Mamba-2 mixer: chunked SSD, O(1)-state decode
  transformer  — TransformerLM over layer roles, lm_apply, the per-layer
                 cache pool (KV or conv + SSM state)
"""
from repro_torch.models import (  # noqa: F401
    attention, io, layers, mamba2, moe, recommender, rnn, transformer)
