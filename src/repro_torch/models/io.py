"""Token IO boundary: the serving-time vocabulary recovery of Eq. 3.

Of the JAX package's ``models/io.py`` only ``recover_topk_spec`` is ported
so far: the shared recovery core of the retrieval serving path (and, later,
the LM head).  It runs on the f32 path: log_softmax, then the fused
decode-topk (the CUDA kernel for CUDA tensors, its plain version for CPU
tensors), then dead rows masked to (-inf, 0).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels import ops


def recover_topk_spec(spec: BloomSpec, logits: torch.Tensor,
                      topk: int = 16, *,
                      active: Optional[torch.Tensor] = None):
    """Top-k recovery keyed by a BloomSpec: (scores, ids), each
    (..., topk).

    Equal Eq. 3 scores resolve to the lowest item id, as on every decode
    path of the JAX package.  ``active`` (...,) bool masks retired rows to
    scores=-inf / ids=0 and lets the kernel skip them.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, ids = ops.bloom_decode_topk(logp, spec, topk, active=active)
    if active is not None:
        live = active[..., None].to(torch.bool)
        scores = torch.where(live, scores, -torch.inf)
        ids = torch.where(live, ids, 0)
    return scores, ids
