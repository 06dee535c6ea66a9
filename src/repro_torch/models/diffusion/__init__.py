"""Latent diffusion: noise schedule, DiT, VAE, DDIM sampler."""
