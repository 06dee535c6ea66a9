"""Shared diffusion-config plumbing (a copy of the JAX package's
``repro/configs/diffusion_common.py``): every diffusion arch bundles a
backbone + the f8 VAE + its conditioning interface."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.models.diffusion.vae import VAEConfig

# Stable-Diffusion-class f8 autoencoder (3 stride-2 stages).
FULL_VAE = VAEConfig(in_ch=3, base_ch=128, ch_mult=(1, 2, 4), z_ch=4, n_res=2)
REDUCED_VAE = VAEConfig(in_ch=3, base_ch=16, ch_mult=(1, 2), z_ch=4, n_res=1)


class DiffusionConfig(NamedTuple):
    backbone: str          # "dit" | "unet" | "mmdit"
    net: Any               # DiTConfig | MMDiTConfig
    vae: VAEConfig
    ctx_len: int = 77      # text tokens (unet / mmdit conditioning)
    ctx_dim: int = 768
    pooled_dim: int = 512  # pooled conditioning (dit / mmdit vec)

    @property
    def latent_res(self) -> int:
        if self.backbone == "unet":
            raise AttributeError("UNet latent res comes from the shape cell")
        return self.net.img_res


def latent_res_of(img_res: int, vae: VAEConfig) -> int:
    return img_res // vae.downsample
