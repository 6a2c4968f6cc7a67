"""Hand-written Hopper kernels for the paper's IO hot spots (+ ops/ref).

  bloom_decode_topk — fused Eq. 3 + top-k (serving path; the (B, d) score
                      matrix is never materialised); CUDA source in
                      csrc/bloom_decode_topk.cu
  bloom_embed       — the Bloom token embedding's k-way row gather-sum,
                      forward only; CUDA source in csrc/bloom_embed.cu

Each kernel module holds the CUDA wrapper, its plain PyTorch version and
the entry that picks one by the tensors' device (common.resolve_impl).
"""
from repro_torch.kernels import ops, ref  # noqa: F401
