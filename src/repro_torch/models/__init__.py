"""Models: layers, the recommender tower, the IO boundary, the decoder
LMs (dense, MoE, SSM, hybrid, vlm) and the encoder-decoder (audio).

  layers       — initialisers, dense layer, RMSNorm, LayerNorm, RoPE,
                 SwiGLU
  recommender  — the paper's feed-forward tower (FFTower), also a classifier
  rnn          — the GRU / LSTM session models (RNNLM)
  io           — Bloom / dense token embedding, LM head, Eq. 3 recovery
  attention    — self-attention (prefill + slot decode; non-causal for
                 the encoder) and the encoder-decoder's cross attention
  moe          — the MoE FFN: top-k routing into capacity buffers
  mamba2       — the Mamba-2 mixer: chunked SSD, O(1)-state decode
  transformer  — TransformerLM over layer roles, lm_apply (with the vlm
                 stub frontend's prefix), the per-layer cache pool (KV or
                 conv + SSM state)
  encdec       — EncDec (whisper-style): the stub audio frontend, the
                 encoder, the decoder with cross attention, its caches
"""
from repro_torch.models import (  # noqa: F401
    attention, encdec, io, layers, mamba2, moe, recommender, rnn,
    transformer)
