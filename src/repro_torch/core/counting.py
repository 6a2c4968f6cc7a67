"""Counting Bloom embeddings — the paper's own 'future work' (Sec. 7):

  "one could enhance the proposed approach by considering further
   extensions of Bloom filters such as counting Bloom filters. In theory,
   those extensions could provide a more compact representation by
   breaking the binary nature of the embedding."

The JAX package's ``core/counting.py`` in PyTorch.  The encoding counts
how many (item, projection) pairs land on each bit instead of saturating
at 1 — u[i] = #{(p, j) : H_j(p) = i} — and the training target becomes
the normalized count distribution.  Recovery stays Eq. 3 (the count
encoding only changes the *target*; the model's softmax output is
unchanged), so serving code is identical: ``CountingBloomIO.decode`` is
``core.alternatives.eq3_scores``, the ``bloom_decode`` kernel on CUDA.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import losses
from repro_torch.core.alternatives import eq3_scores
from repro_torch.core.bloom import BloomSpec
from repro_torch.kernels.common import resolve_device


def encode_counting(spec: BloomSpec, p: torch.Tensor,
                    hash_matrix: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """Count-valued Bloom encoding: u[i] = multiplicity of bit i.

    p: (..., c_max) padded item ids (-1 = pad, adding nothing) ->
    (..., m) counts in ``dtype`` (an f32 scatter-add of whole numbers:
    exact in any order).
    """
    valid = p >= 0
    idx = spec.indices_for(torch.where(valid, p, torch.zeros_like(p)),
                           hash_matrix)                      # (..., c, k)
    flat = idx.reshape(*p.shape[:-1], -1).long()
    mask = valid.repeat_interleave(spec.k, dim=-1).reshape(flat.shape)
    u = torch.zeros((*p.shape[:-1], spec.m), dtype=dtype, device=p.device)
    return u.scatter_add(-1, flat, mask.to(dtype))


def counting_xent_multilabel(spec: BloomSpec, logits: torch.Tensor,
                             targets: torch.Tensor,
                             hash_matrix: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """CE against the normalized COUNT distribution (vs the paper's
    binary multi-hot): collisions keep their multiplicity.  The mass is
    clipped at 1e-9, so an all-pad row has target 0 and loss 0."""
    u = encode_counting(spec, targets, hash_matrix)
    mass = torch.clamp(u.sum(-1, keepdim=True), min=1e-9)
    return losses.softmax_xent_dense(logits, u / mass)


class CountingBloomIO:
    """IOEmbedding-compatible counting variant (drop-in for BloomIO):
    input spec from ``seed``, output spec from ``seed + 1``.  It holds no
    tensor; ``device`` is checked as ``BloomIO.build`` checks it (CUDA
    unless the caller asks for the CPU, a raise when CUDA is absent)."""

    def __init__(self, d: int, m: int, k: int = 4, seed: int = 0,
                 device=None):
        resolve_device(device)
        self.name = "CBE-count"
        self.d, self.m_in, self.m_out = d, m, m
        self.spec_in = BloomSpec(d=d, m=m, k=k, seed=seed)
        self.spec_out = BloomSpec(d=d, m=m, k=k, seed=seed + 1)

    def encode_input(self, p):
        # counting inputs carry multiplicity into the first layer too
        return encode_counting(self.spec_in, p)

    def loss(self, pred, q):
        return counting_xent_multilabel(self.spec_out, pred, q)

    def decode(self, pred):
        return eq3_scores(self.spec_out, pred)
