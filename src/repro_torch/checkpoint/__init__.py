"""Checkpointing in the JAX package's npz + manifest format."""
