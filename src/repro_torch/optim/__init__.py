"""Optimizers in the optax style (``optimizers``)."""
