"""Layers shared by the DiT and the VAE."""
