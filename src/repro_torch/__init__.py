"""PyTorch/CUDA port of the Bloom-embedding system in ``repro``.

Same subpackage and module layout as the JAX package, so each module names
its counterpart there.  Entry points run on CUDA unless the caller passes
``device="cpu"``, and raise when CUDA is asked for and absent; the fused
kernels are hand-written CUDA for Hopper (``kernels/csrc``), built at first
use, with plain PyTorch versions that CPU tensors take.
"""
