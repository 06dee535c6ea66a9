"""Small CLIP-style text encoder used for diffusion conditioning — the
port of the JAX package's ``repro/models/diffusion/text_encoder.py``.

A bidirectional transformer over hash-token ids → per-token context
(``out_dim`` 768: the MMDiT's ``txt``) and a pooled vector (``pool_dim``
512: its ``vec``).  Blocks are an ``nn.ModuleList`` named as the JAX
tree (``blocks.<i>.ln1``, ``qkv``, ``proj``, ``ln2``, ``mlp``).  Its
attention goes through :func:`repro_torch.models.common.attention.sdpa`
with the port's default, the kernel (the JAX config has no kernel flag):
K4's float32 kernel on the card (head dim 64), the plain version on CPU
tensors.  Padding tokens are not
masked out of the attention, as in the JAX package; only the pooling
skips them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.common import layers as L
from repro_torch.models.common.attention import sdpa


class TextEncoderConfig(NamedTuple):
    vocab: int = 32768
    max_len: int = 77
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    out_dim: int = 768       # ctx token dim handed to the diffusion backbone
    pool_dim: int = 512      # pooled embedding dim

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


class Block(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = L.LayerNorm(d, **factory)
        self.qkv = L.Dense(d, 3 * d, bias=False, **factory)
        self.proj = L.Dense(d, d, bias=False, **factory)
        self.ln2 = L.LayerNorm(d, **factory)
        self.mlp = L.MLP(d, 4 * d, linear=L.Dense, **factory)

    def forward(self, h):
        cfg = self.cfg
        hn = self.ln1(h)
        b, s, d = hn.shape
        qkv = self.qkv(hn).reshape(b, s, 3, cfg.n_heads, cfg.head_dim)
        att = sdpa(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)
        h = h + self.proj(att.reshape(b, s, d))
        return h + self.mlp(self.ln2(h))


class TextEncoder(nn.Module):
    """Built on ``device`` (the card unless the caller asks for the CPU);
    weights drawn as the JAX package's ``init_text_encoder`` draws them,
    from ``generator``: embeddings and positions ~ N(0, 0.02), dense
    weights ~ N(0, 1/fan_in), biases zero, LayerNorm scales one."""

    def __init__(self, cfg: TextEncoderConfig, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = dict(device=torch.device(device), dtype=dtype)
        d = cfg.d_model
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, d, **f))
        self.pos = nn.Parameter(torch.empty(cfg.max_len, d, **f))
        self.blocks = nn.ModuleList(Block(cfg, **f)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.LayerNorm(d, **f)
        self.to_ctx = L.Dense(d, cfg.out_dim, bias=False, **f)
        self.to_pool = L.Dense(d, cfg.pool_dim, bias=False, **f)
        with torch.no_grad():
            self.embed.normal_(0.0, 0.02, generator=generator)
            self.pos.normal_(0.0, 0.02, generator=generator)
            for m in self.modules():
                if isinstance(m, L.Dense):
                    m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()

    def forward(self, tokens):
        """tokens: (B, S) int -> (ctx (B, S, out_dim), pooled (B,
        pool_dim))."""
        tokens = tokens.long()
        mask = (tokens != 0).to(self.embed.dtype)
        x = self.embed[tokens] + self.pos[None, : tokens.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        ctx = self.to_ctx(x)
        denom = mask.sum(-1, keepdim=True).clamp(min=1.0)
        pooled = torch.einsum("bsd,bs->bd", x, mask) / denom
        return ctx, self.to_pool(pooled)
