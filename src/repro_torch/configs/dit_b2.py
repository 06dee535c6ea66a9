"""dit-b2 — Diffusion Transformer B/2 (Peebles & Xie). [arXiv:2212.09748; paper]

The port of the JAX package's ``repro/configs/dit_b2.py``: img_res=256
patch=2 n_layers=12 d_model=768 n_heads=12.  The backbone sees the f8
VAE latent (256→32), patch 2 → 256 tokens at train_256.
"""
from __future__ import annotations

from repro_torch.configs.diffusion_common import (DiffusionConfig, FULL_VAE,
                                                  REDUCED_VAE, latent_res_of)
from repro_torch.configs.registry import ArchSpec
from repro_torch.configs.shapes import ShapeCell
from repro_torch.models.diffusion.dit import DiTConfig


def make_config(cell: ShapeCell) -> DiffusionConfig:
    latent = latent_res_of(cell.img_res or 256, FULL_VAE)
    return DiffusionConfig(
        backbone="dit",
        net=DiTConfig(img_res=latent, in_ch=FULL_VAE.z_ch, patch=2,
                      n_layers=12, d_model=768, n_heads=12, ctx_dim=512),
        vae=FULL_VAE,
    )


def make_reduced() -> DiffusionConfig:
    return DiffusionConfig(
        backbone="dit",
        net=DiTConfig(img_res=8, in_ch=REDUCED_VAE.z_ch, patch=2,
                      n_layers=2, d_model=64, n_heads=4, ctx_dim=512),
        vae=REDUCED_VAE,
    )


ARCH = ArchSpec(
    name="dit-b2",
    family="diffusion-dit",
    make_config=make_config,
    make_reduced=make_reduced,
    shapes=("train_256", "gen_1024", "gen_fast", "train_1024"),
    optimizer="adamw",
    technique="Primary: full Algorithm 1 serve path (0/K/N steps).",
    source="arXiv:2212.09748; paper",
)
