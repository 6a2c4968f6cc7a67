"""Models: the dense layer, the recommender tower and the IO boundary.

  layers       — dense layer + truncated-normal init
  recommender  — the paper's feed-forward recommender tower (FFTower)
  io           — Eq. 3 top-k recovery (recover_topk_spec)
"""
from repro_torch.models import io, layers, recommender  # noqa: F401
