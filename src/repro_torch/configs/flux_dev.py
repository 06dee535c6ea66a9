"""flux-dev — MMDiT rectified-flow model. [BFL tech report; unverified]

The port of the JAX package's ``repro/configs/flux_dev.py``: latent 128
at 1024 px, 19 double + 38 single blocks, d_model=3072, 24 heads,
≈12B params, bf16 parameters.  CacheGenius adapted: the rectified-flow
analogue of SDEdit starts integration at x_t = (1−t)·z_ref + t·ε with
t = strength (``rf_edit`` in models/diffusion/sampler.py).
"""
from __future__ import annotations

from repro_torch.configs.diffusion_common import (DiffusionConfig, FULL_VAE,
                                                  REDUCED_VAE, latent_res_of)
from repro_torch.configs.registry import ArchSpec
from repro_torch.configs.shapes import ShapeCell
from repro_torch.models.diffusion.mmdit import MMDiTConfig


def make_config(cell: ShapeCell) -> DiffusionConfig:
    latent = latent_res_of(cell.img_res or 1024, FULL_VAE)
    return DiffusionConfig(
        backbone="mmdit",
        net=MMDiTConfig(img_res=latent, in_ch=FULL_VAE.z_ch, patch=2,
                        n_double=19, n_single=38, d_model=3072, n_heads=24,
                        txt_len=256, txt_dim=768, vec_dim=512),
        vae=FULL_VAE,
        ctx_len=256, ctx_dim=768,
    )


def make_reduced() -> DiffusionConfig:
    return DiffusionConfig(
        backbone="mmdit",
        net=MMDiTConfig(img_res=8, in_ch=REDUCED_VAE.z_ch, patch=2,
                        n_double=2, n_single=2, d_model=96, n_heads=4,
                        txt_len=8, txt_dim=64, vec_dim=64),
        vae=REDUCED_VAE,
        ctx_len=8, ctx_dim=64, pooled_dim=64,
    )


ARCH = ArchSpec(
    name="flux-dev",
    family="diffusion-mmdit",
    make_config=make_config,
    make_reduced=make_reduced,
    shapes=("train_256", "gen_1024", "gen_fast", "train_1024"),
    optimizer="adamw",
    fsdp_params=True,
    param_dtype="bfloat16",
    technique=("Adapted: rf_edit — rectified-flow SDEdit analogue; same "
               "Algorithm 1 thresholds."),
    source="BFL tech report; unverified",
)
