"""Convolutional VAE (the LDM autoencoder) — the port of the JAX
package's ``repro/models/diffusion/vae.py``.

f8 spatial compression (three stride-2 stages), GroupNorm+SiLU residual
blocks, 4 latent channels.  Tensors are NHWC at ``encode``/``decode``
as in the JAX package; the convolutions see channels-last views.
Submodule names mirror the JAX parameter tree (``enc.stage0.res1.conv2``
...), so :mod:`repro_torch.convert` maps one onto the other by name.

``use_pallas`` keeps the JAX name and, as in the port's DiT, defaults to
True: every resblock's two GroupNorm+SiLU activations go through
:func:`repro_torch.kernels.ops.groupnorm_silu` (the hand-written kernel
on the card, the plain version on CPU tensors).  The output norm before
``to_moments`` / ``to_img`` stays plain, as in the JAX package.
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import layers as L


class VAEConfig(NamedTuple):
    in_ch: int = 3
    base_ch: int = 64
    ch_mult: tuple = (1, 2, 4)   # one stride-2 per stage
    z_ch: int = 4
    n_res: int = 1

    @property
    def downsample(self) -> int:
        return 2 ** len(self.ch_mult)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, use_pallas: bool = True):
        super().__init__()
        self.use_pallas = use_pallas
        self.norm1 = L.GroupNorm(in_ch)
        self.conv1 = L.Conv(in_ch, out_ch, 3)
        self.norm2 = L.GroupNorm(out_ch)
        self.conv2 = L.Conv(out_ch, out_ch, 3)
        self.skip = L.Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def _act(self, norm, x):
        if self.use_pallas:
            return ops.groupnorm_silu(x.contiguous(), norm.scale, norm.bias)
        return F.silu(norm(x))

    def forward(self, x):
        h = self.conv1(self._act(self.norm1, x))
        h = self.conv2(self._act(self.norm2, h))
        return h + (self.skip(x) if self.skip is not None else x)


def _stage(cfg: VAEConfig, sample_name: str, in_ch: int, out_ch: int,
           sample_out: int, use_pallas: bool) -> nn.ModuleDict:
    stage = nn.ModuleDict({sample_name: L.Conv(in_ch, sample_out, 3)})
    for ri in range(cfg.n_res):
        stage[f"res{ri}"] = ResBlock(out_ch, out_ch, use_pallas=use_pallas)
    return stage


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig, *,
                 generator: torch.Generator = None, use_pallas: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_pallas = use_pallas
        enc = nn.ModuleDict({"stem": L.Conv(cfg.in_ch, cfg.base_ch, 3)})
        ch = cfg.base_ch
        for si, mult in enumerate(cfg.ch_mult):
            out = cfg.base_ch * mult
            enc[f"stage{si}"] = _stage(cfg, "down", ch, out, out,
                                       use_pallas)
            ch = out
        enc["norm_out"] = L.GroupNorm(ch)
        enc["to_moments"] = L.Conv(ch, 2 * cfg.z_ch, 1)
        dec = nn.ModuleDict({"from_z": L.Conv(cfg.z_ch, ch, 1)})
        for si, mult in enumerate(reversed(cfg.ch_mult)):
            out = cfg.base_ch * mult
            dec[f"stage{si}"] = _stage(cfg, "up", ch, out, out * 4,
                                       use_pallas)
            ch = out
        dec["norm_out"] = L.GroupNorm(ch)
        dec["to_img"] = L.Conv(ch, cfg.in_ch, 3)
        self.enc, self.dec = enc, dec
        if generator is not None:
            L.init_normal_(self, generator)

    def _stage_res(self, stage, h):
        for ri in range(self.cfg.n_res):
            h = stage[f"res{ri}"](h)
        return h

    def encode(self, x):
        """x: (B, H, W, 3) -> latent moments (mean, logvar)."""
        enc = self.enc
        h = enc["stem"](x)
        for si in range(len(self.cfg.ch_mult)):
            stage = enc[f"stage{si}"]
            h = self._stage_res(stage, stage["down"](h, stride=2))
        moments = enc["to_moments"](F.silu(enc["norm_out"](h)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        """z: (B, h, w, z_ch) -> image (B, H, W, 3)."""
        dec = self.dec
        h = dec["from_z"](z)
        for si in range(len(self.cfg.ch_mult)):
            stage = dec[f"stage{si}"]
            h = stage["up"](h)
            b, hh, ww, c4 = h.shape
            # pixel-shuffle with the JAX package's channel order
            h = h.reshape(b, hh, ww, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
            h = self._stage_res(stage, h.reshape(b, hh * 2, ww * 2, c4 // 4))
        return dec["to_img"](F.silu(dec["norm_out"](h)))
