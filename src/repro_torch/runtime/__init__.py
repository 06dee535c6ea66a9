"""Serving runtime: the diffusion backend and the request engine."""
