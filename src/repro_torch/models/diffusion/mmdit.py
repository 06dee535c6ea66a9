"""Flux-class MMDiT (rectified-flow multimodal DiT; BFL tech report) —
the port of the JAX package's ``repro/models/diffusion/mmdit.py``.

Double-stream blocks (separate image/text streams with joint attention
over ``[txt; img]``) followed by single-stream blocks over the
concatenated sequence, adaLN modulation from (timestep ⊕ guidance ⊕
pooled text).  The assigned ``flux-dev`` config: 19 double + 38 single
blocks, d_model=3072, 24 heads of 128, latent 128 with patch 2 → 4096
image tokens (+ 256 text tokens), ≈11.8B params, bf16.

The JAX version scans stacked block parameters; here the blocks are
``nn.ModuleList``s run in a Python loop.  Parameter names follow the JAX
tree (``double.<i>.img.mod``, ``single.<i>.linear1``, ``final_mod``, ...)
so that :func:`repro_torch.convert.mmdit_params_from_jax` is a rename.
Dense layers add their bias in the output dtype, as the JAX ``dense``
does (:class:`repro_torch.models.common.layers.Dense`).

``use_pallas`` keeps the JAX name and, as in the port's DiT, defaults to
True: the joint attention goes to K4 on the card (its bf16 kernel at
full width), the plain version on CPU tensors.  The blocks read the
model's ``cfg`` at each call, so ``model.cfg = model.cfg._replace(
use_pallas=False)`` runs the same weights on the plain path.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import layers as L
from repro_torch.models.common.attention import sdpa


class MMDiTConfig(NamedTuple):
    img_res: int = 128       # latent resolution
    in_ch: int = 4
    patch: int = 2
    n_double: int = 19
    n_single: int = 38
    d_model: int = 3072
    n_heads: int = 24
    mlp_ratio: float = 4.0
    txt_len: int = 256
    txt_dim: int = 768       # incoming text token dim
    vec_dim: int = 512       # pooled conditioning
    use_pallas: bool = True  # flash-attention kernel

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_img_tokens(self) -> int:
        return (self.img_res // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.in_ch

    @property
    def hidden(self) -> int:
        return int(self.d_model * self.mlp_ratio)


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


class Stream(nn.Module):
    """One stream (image or text) of a double block."""

    def __init__(self, cfg: MMDiTConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.mod = L.Dense(d, 6 * d, **factory)
        self.qkv = L.Dense(d, 3 * d, bias=False, **factory)
        self.proj = L.Dense(d, d, bias=False, **factory)
        self.mlp = L.MLP(d, cfg.hidden, linear=L.Dense, **factory)
        self.q_norm = L.RMSNorm(cfg.head_dim, **factory)
        self.k_norm = L.RMSNorm(cfg.head_dim, **factory)

    def qkv_of(self, cfg: MMDiTConfig, h, mod):
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        hn = L.modulate(L.layernorm(h), sh1, sc1)
        b, t, _ = hn.shape
        qkv = self.qkv(hn).reshape(b, t, 3, cfg.n_heads, cfg.head_dim)
        return (self.q_norm(qkv[:, :, 0]), self.k_norm(qkv[:, :, 1]),
                qkv[:, :, 2], (sh2, sc2, g1, g2))


class DoubleBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, **factory):
        super().__init__()
        self.img = Stream(cfg, **factory)
        self.txt = Stream(cfg, **factory)

    def forward(self, img, txt, cond, cfg: MMDiTConfig):
        c = F.silu(cond)
        qi, ki, vi, (shi, sci, gi1, gi2) = self.img.qkv_of(
            cfg, img, self.img.mod(c))
        qt, kt, vt, (sht, sct, gt1, gt2) = self.txt.qkv_of(
            cfg, txt, self.txt.mod(c))
        # joint attention over [txt ; img]
        q = torch.cat([qt, qi], dim=1)
        k = torch.cat([kt, ki], dim=1)
        v = torch.cat([vt, vi], dim=1)
        att = sdpa(q, k, v, causal=False, use_pallas=cfg.use_pallas)
        n_txt = txt.shape[1]
        ta, ia = att[:, :n_txt], att[:, n_txt:]
        b = img.shape[0]
        img = img + gi1[:, None, :] * self.img.proj(
            ia.reshape(b, -1, cfg.d_model))
        txt = txt + gt1[:, None, :] * self.txt.proj(
            ta.reshape(b, -1, cfg.d_model))
        img = img + gi2[:, None, :] * self.img.mlp(
            L.modulate(L.layernorm(img), shi, sci))
        txt = txt + gt2[:, None, :] * self.txt.mlp(
            L.modulate(L.layernorm(txt), sht, sct))
        return img, txt


class SingleBlock(nn.Module):
    """Fused qkv + MLP-in (``linear1``) and attention-out + MLP-out
    (``linear2``), the flux single-block layout."""

    def __init__(self, cfg: MMDiTConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.mod = L.Dense(d, 3 * d, **factory)
        self.linear1 = L.Dense(d, 3 * d + cfg.hidden, bias=False, **factory)
        self.linear2 = L.Dense(d + cfg.hidden, d, bias=False, **factory)
        self.q_norm = L.RMSNorm(cfg.head_dim, **factory)
        self.k_norm = L.RMSNorm(cfg.head_dim, **factory)

    def forward(self, x, cond, cfg: MMDiTConfig):
        sh, sc, g = self.mod(F.silu(cond)).chunk(3, dim=-1)
        u = self.linear1(L.modulate(L.layernorm(x), sh, sc))
        b, t, _ = u.shape
        d = cfg.d_model
        # v stays a strided view of u (rows of 3d + hidden elements)
        qkv = u[..., : 3 * d].reshape(b, t, 3, cfg.n_heads, cfg.head_dim)
        m = u[..., 3 * d:]
        att = sdpa(self.q_norm(qkv[:, :, 0]), self.k_norm(qkv[:, :, 1]),
                   qkv[:, :, 2], causal=False, use_pallas=cfg.use_pallas)
        out = self.linear2(torch.cat([att.reshape(b, t, d), _gelu(m)],
                                     dim=-1))
        return x + g[:, None, :] * out


class MMDiT(nn.Module):
    """Velocity-prediction MMDiT, built on ``device`` in ``dtype``.

    Every weight is drawn as the JAX package's ``init_mmdit`` draws it,
    from ``generator`` (or the device's default generator): dense weights
    ~ N(0, 1/fan_in), biases zero, RMSNorm scales one, ``img_pos`` ~
    N(0, 0.02); the adaLN projections (``mod``, ``final_mod``) and
    ``final_proj`` are zero, so at init every gate is 0, every block the
    identity and the velocity exactly 0 (see :func:`perturb_zero_init_`)."""

    def __init__(self, cfg: MMDiTConfig, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = dict(device=torch.device(device), dtype=dtype)
        d = cfg.d_model
        self.cfg = cfg
        self.img_in = L.Dense(cfg.patch_dim, d, **f)
        self.txt_in = L.Dense(cfg.txt_dim, d, **f)
        self.time_mlp = L.MLP(256, d, out_dim=d, linear=L.Dense, **f)
        self.vec_mlp = L.MLP(cfg.vec_dim, d, out_dim=d, linear=L.Dense, **f)
        self.guidance_mlp = L.MLP(256, d, out_dim=d, linear=L.Dense, **f)
        self.img_pos = nn.Parameter(torch.empty(cfg.n_img_tokens, d, **f))
        # registered as "double", the JAX tree's name; nn.Module's own
        # double() method shadows that attribute (and add_module refuses
        # it), so the list goes into _modules and is read through
        # ``double_blocks``
        self._modules["double"] = nn.ModuleList(
            DoubleBlock(cfg, **f) for _ in range(cfg.n_double))
        self.single = nn.ModuleList(SingleBlock(cfg, **f)
                                    for _ in range(cfg.n_single))
        self.final_mod = L.Dense(d, 2 * d, **f)
        self.final_proj = L.Dense(d, cfg.patch_dim, **f)
        self._init(generator)

    @property
    def double_blocks(self) -> nn.ModuleList:
        return self._modules["double"]

    @torch.no_grad()
    def _init(self, generator) -> None:
        zero = {id(m) for m in self.zero_init_layers()}
        for m in self.modules():
            if isinstance(m, L.Dense):
                if id(m) in zero:
                    m.weight.zero_()
                else:
                    m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                     generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        self.img_pos.normal_(0.0, 0.02, generator=generator)

    def zero_init_layers(self):
        """The layers the JAX package initialises to zero: every block's
        adaLN projection, ``final_mod`` and ``final_proj``."""
        return ([s.mod for blk in self.double_blocks
                 for s in (blk.img, blk.txt)]
                + [blk.mod for blk in self.single]
                + [self.final_mod, self.final_proj])

    @torch.no_grad()
    def set_img_res(self, img_res: int, *,
                    generator: Optional[torch.Generator] = None) -> None:
        """Resize to another latent resolution: only ``img_pos`` depends
        on it (``n_img_tokens`` rows), so one set of weights serves two
        cells; the new rows are drawn ~ N(0, 0.02) from ``generator``."""
        cfg = self.cfg._replace(img_res=img_res)
        pos = torch.empty(cfg.n_img_tokens, cfg.d_model,
                          device=self.img_pos.device,
                          dtype=self.img_pos.dtype)
        pos.normal_(0.0, 0.02, generator=generator)
        self.img_pos = nn.Parameter(pos)
        self.cfg = cfg

    def forward(self, x_img, t, ctx):
        """Velocity.  x_img: (B, res, res, in_ch); t: (B,) in [0, 1];
        ctx: dict(txt=(B, txt_len, txt_dim), vec=(B, vec_dim)[,
        guidance=(B,)])."""
        cfg = self.cfg
        img = self.img_in(L.patchify(x_img, cfg.patch))
        img = img + self.img_pos[None].to(img.dtype)
        txt = self.txt_in(ctx["txt"].to(img.dtype))
        # t * 1000 in t's dtype (bf16 rounds there), then the f32 embedding
        cond = self.time_mlp(
            L.timestep_embedding(t * 1000.0, 256).to(img.dtype))
        cond = cond + self.vec_mlp(ctx["vec"].to(img.dtype))
        if "guidance" in ctx:
            cond = cond + self.guidance_mlp(
                L.timestep_embedding(ctx["guidance"], 256).to(img.dtype))
        for blk in self.double_blocks:
            img, txt = blk(img, txt, cond, cfg)
        x = torch.cat([txt, img], dim=1)
        for blk in self.single:
            x = blk(x, cond, cfg)
        img = x[:, txt.shape[1]:]
        sh, sc = self.final_mod(F.silu(cond)).chunk(2, dim=-1)
        img = self.final_proj(L.modulate(L.layernorm(img), sh, sc))
        return L.unpatchify(img, cfg.patch, cfg.img_res, cfg.img_res,
                            cfg.in_ch)


@torch.no_grad()
def perturb_zero_init_(model: MMDiT, generator: Optional[torch.Generator],
                       std: float = 0.02) -> None:
    """Fill the zero-initialised layers (adaLN projections, ``final_mod``,
    ``final_proj``) with N(0, std), drawn on the model's device from
    ``generator``.  An untouched MMDiT predicts v = 0 whatever its input,
    so a check of random weights against a reference needs this to check
    anything."""
    for lin in model.zero_init_layers():
        for p in (lin.weight, lin.bias):
            p.normal_(0.0, std, generator=generator)


def make_v_fn(model: MMDiT):
    def v_fn(x, t, ctx):
        return model(x, t, ctx)
    return v_fn
