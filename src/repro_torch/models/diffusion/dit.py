"""DiT — Diffusion Transformer (Peebles & Xie, arXiv:2212.09748).

The port of the JAX package's ``repro/models/diffusion/dit.py``:
adaLN-Zero conditioning on (timestep ⊕ pooled text embedding),
patchified latent tokens, bidirectional attention.  The JAX version
scans one stacked block over the layer axis; here the blocks are an
``nn.ModuleList`` run in a Python loop.

``use_pallas`` and ``use_pallas_adaln`` keep the JAX names but select
the port's hand-written kernels (flash attention, fused adaLN), and
default to True — the reference defaults them to False.  On CPU tensors
the kernel dispatch takes the plain versions, so the flags only change
what runs on the card.
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import layers as L
from repro_torch.models.common.attention import sdpa


class DiTConfig(NamedTuple):
    img_res: int = 32          # latent resolution fed to the backbone
    in_ch: int = 4
    patch: int = 2
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    mlp_ratio: float = 4.0
    ctx_dim: int = 512         # pooled conditioning vector (text tower)
    use_pallas: bool = True          # flash-attention kernel
    use_pallas_adaln: bool = True    # fused adaLN kernel

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_tokens(self) -> int:
        return (self.img_res // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.in_ch


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.proj = nn.Linear(d, d, bias=False)
        self.mlp = L.MLP(d, int(d * cfg.mlp_ratio))
        self.ada = nn.Linear(d, 6 * d)   # adaLN-zero: zero-init projection

    def _modulate(self, x, shift, scale):
        if self.cfg.use_pallas_adaln:
            return ops.adaln_modulate(x, shift, scale)
        return L.modulate(L.layernorm(x), shift, scale)

    def forward(self, x, cond):
        """x: (B, T, D); cond: (B, D)."""
        cfg = self.cfg
        sh1, sc1, g1, sh2, sc2, g2 = self.ada(F.silu(cond)).chunk(6, dim=-1)
        h = self._modulate(x, sh1, sc1)
        b, t, d = h.shape
        qkv = self.qkv(h).reshape(b, t, 3, cfg.n_heads, cfg.head_dim)
        att = sdpa(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False,
                   use_pallas=cfg.use_pallas)
        x = x + g1[:, None, :] * self.proj(att.reshape(b, t, d))
        h2 = self._modulate(x, sh2, sc2)
        return x + g2[:, None, :] * self.mlp(h2)


class DiT(nn.Module):
    """eps-prediction DiT.  ``generator`` draws the JAX package's
    initialisation (dense weights ~ N(0, 1/fan_in), positional embedding
    ~ N(0, 0.02), adaLN and output heads zero)."""

    def __init__(self, cfg: DiTConfig, *,
                 generator: torch.Generator = None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.patch_embed = nn.Linear(cfg.patch_dim, d)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.n_tokens, d))
        self.t_mlp = L.MLP(256, d, out_dim=d)
        self.ctx_proj = nn.Linear(cfg.ctx_dim, d)
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.n_layers))
        self.final_ada = nn.Linear(d, 2 * d)
        self.final_proj = nn.Linear(d, cfg.patch_dim)
        if generator is not None:
            L.init_normal_(self, generator)
            with torch.no_grad():
                self.pos_embed.normal_(0.0, 0.02, generator=generator)
                for zero in ([blk.ada for blk in self.blocks]
                             + [self.final_ada, self.final_proj]):
                    zero.weight.zero_()
                    zero.bias.zero_()

    def forward(self, x_img, t, ctx):
        """x_img: (B, res, res, in_ch) latent; t: (B,) timesteps;
        ctx: (B, ctx_dim) pooled conditioning.  Returns eps."""
        cfg = self.cfg
        x = self.patch_embed(L.patchify(x_img, cfg.patch)) \
            + self.pos_embed[None].to(x_img.dtype)
        t_emb = L.timestep_embedding(t, 256).to(x.dtype)
        cond = self.t_mlp(t_emb) + self.ctx_proj(ctx.to(x.dtype))
        for blk in self.blocks:
            x = blk(x, cond)
        shift, scale = self.final_ada(F.silu(cond)).chunk(2, dim=-1)
        x = self.final_proj(L.modulate(L.layernorm(x), shift, scale))
        return L.unpatchify(x, cfg.patch, cfg.img_res, cfg.img_res,
                            cfg.in_ch)


def perturb_zero_init_(dit: DiT, generator: torch.Generator,
                       std: float = 0.02) -> None:
    """Fill the zero-initialised adaLN and output heads with N(0, std).
    An untouched DiT predicts eps = 0 whatever its input, so a check of
    random weights against a reference needs this to check anything."""
    with torch.no_grad():
        for lin in [blk.ada for blk in dit.blocks] + [dit.final_ada,
                                                      dit.final_proj]:
            for p in (lin.weight, lin.bias):
                p.copy_(torch.randn(p.shape, generator=generator) * std)


def make_eps_fn(dit: DiT):
    def eps_fn(x, t, ctx):
        return dit(x, t, ctx)
    return eps_fn
