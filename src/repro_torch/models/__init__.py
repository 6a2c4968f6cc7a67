"""Models: layers, the recommender tower, the IO boundary and the dense LM.

  layers       — initialisers, dense layer, RMSNorm, RoPE, SwiGLU
  recommender  — the paper's feed-forward tower (FFTower), also a classifier
  rnn          — the GRU / LSTM session models (RNNLM)
  io           — Bloom / dense token embedding, LM head, Eq. 3 recovery
  attention    — dense-decoder self-attention (prefill + slot decode)
  transformer  — TransformerLM, lm_apply, the per-layer KV cache pool
"""
from repro_torch.models import (  # noqa: F401
    attention, io, layers, recommender, rnn, transformer)
