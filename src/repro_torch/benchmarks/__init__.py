"""Benchmarks of the port: twins of the JAX package's ``benchmarks/``
that check the port against the committed ``BENCH_*.json`` (read-only)."""
