"""Hand-written Hopper kernels for the paper's IO hot spots (+ ops/ref).

  bloom_decode_topk — fused Eq. 3 + top-k (serving path; the (B, d) score
                      matrix is never materialised); CUDA source in
                      csrc/bloom_decode_topk.cu
  bloom_embed       — the Bloom token embedding's k-way row gather-sum
                      from token ids hashed in the kernel, or from hash
                      indices (an autograd.Function whose backward is
                      bloom_csr or the dense sweep); CUDA source in
                      csrc/bloom_embed.cu, the hash in csrc/bloom_hash.cuh
  bloom_decode      — the full Eq. 3 scores (B, d), differentiable; CUDA
                      source in csrc/bloom_decode.cu
  bloom_csr         — the deterministic CSR scatter-add, the embedding's
                      backward; CUDA source in csrc/bloom_csr.cu
  bloom_ce          — the fused Bloom softmax cross-entropy, forward and
                      backward (training loss); CUDA source in
                      csrc/bloom_ce.cu

Each kernel module holds the CUDA wrapper, its plain PyTorch version and
the entry that picks one by the tensors' device (common.resolve_impl).
"""
from repro_torch.kernels import ops, ref  # noqa: F401
