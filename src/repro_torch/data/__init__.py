"""Synthetic captioned corpus and the hash tokenizer (numpy-only
copies of the JAX package's)."""
