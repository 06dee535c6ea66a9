"""Models the serving path runs: DiT denoiser and VAE."""
