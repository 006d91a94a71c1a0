"""Weights: random reference-format state dicts, and the bridge from the
JAX package's flax variables (``convert``, used by the parity tests)."""
