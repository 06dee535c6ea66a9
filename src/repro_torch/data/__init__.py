"""Synthetic captioned corpus (numpy-only copy of the JAX package's)."""
