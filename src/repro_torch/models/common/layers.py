"""Layers shared by the diffusion models (the subset of the JAX
package's ``repro/models/common/layers.py`` they use).

Layout follows the JAX package at every public function: images and
feature maps are NHWC, tokens are (B, T, D).  Parameters live in
``nn.Module``s (``nn.Linear``, :class:`Dense`, :class:`Conv`,
:class:`GroupNorm`, :class:`LayerNorm`, :class:`RMSNorm`); the functions
here are plain tensor code.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn


def layernorm(x, scale=None, bias=None, *, eps: float = 1e-5):
    """LayerNorm over the last axis, computed in f32; affine-free unless
    ``scale``/``bias`` are given."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis: computed in f32, times ``scale``, cast
    back to x's dtype (the JAX package's ``rmsnorm``)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def modulate(x, shift, scale):
    """adaLN modulation: x * (1 + scale) + shift; shift/scale broadcast
    over tokens."""
    return x * (1.0 + scale[..., None, :]) + shift[..., None, :]


def groupnorm(x, scale, bias, *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm over an NHWC tensor; the group count shrinks until it
    divides the channels (reduced configs), as in the JAX package."""
    dtype = x.dtype
    x = x.float()
    b, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(b, -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * scale.float() + bias.float()).to(dtype)


def timestep_embedding(t, dim: int, *, max_period: float = 10000.0):
    """Sinusoidal timestep embedding. t: (batch,); returns (batch, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def patchify(x, patch: int):
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def unpatchify(x, patch: int, h: int, w: int, c: int):
    """(B, H/p * W/p, p*p*C) -> (B, H, W, C)."""
    b = x.shape[0]
    x = x.reshape(b, h // patch, w // patch, patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class Dense(nn.Linear):
    """The JAX package's ``dense``: ``x @ w`` in the inputs' dtype, then
    the bias cast to the output's dtype and added — in bf16 two roundings,
    where ``nn.Linear`` rounds once.  Same parameters as ``nn.Linear``
    (``weight`` (out, in), ``bias``); nothing is initialised here (the
    owning model draws every weight)."""

    def reset_parameters(self) -> None:
        pass

    def forward(self, x):
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class MLP(nn.Module):
    """fc2(gelu(fc1(x))) with the tanh GELU (``jax.nn.gelu``'s default).
    ``linear`` is the layer class of fc1/fc2 (``nn.Linear``, or
    :class:`Dense`), ``factory`` its ``device``/``dtype``."""

    def __init__(self, dim: int, hidden: int, out_dim=None, *,
                 linear=nn.Linear, **factory):
        super().__init__()
        self.fc1 = linear(dim, hidden, **factory)
        self.fc2 = linear(hidden, dim if out_dim is None else out_dim,
                          **factory)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Conv(nn.Module):
    """2-D convolution on NHWC tensors with "SAME" padding.

    The weight is stored (out, in, kh, kw), PyTorch's layout; the
    NHWC <-> NCHW permutes are views, so the convolution sees a
    channels-last tensor and copies nothing.  Padding follows XLA's SAME
    rule, which puts the odd pixel of a stride-2 pad at the end."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, *, stride: int = 1):
        kh, kw = self.weight.shape[2:]
        xc = x.permute(0, 3, 1, 2)
        pads = []
        for size, k in ((x.shape[2], kw), (x.shape[1], kh)):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        if pads[0] == pads[1] and pads[2] == pads[3]:
            y = F.conv2d(xc, self.weight, self.bias, stride=stride,
                         padding=(pads[2], pads[0]))
        else:
            y = F.conv2d(F.pad(xc, pads), self.weight, self.bias,
                         stride=stride)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """Affine LayerNorm computed in f32 (params named as in the JAX
    package: ``scale``, ``bias``)."""

    def __init__(self, dim: int, **factory):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, **factory))
        self.bias = nn.Parameter(torch.zeros(dim, **factory))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias)


class RMSNorm(nn.Module):
    """RMSNorm (eps 1e-6) with a ``scale``, as the JAX package names it."""

    def __init__(self, dim: int, **factory):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, **factory))

    def forward(self, x):
        return rmsnorm(x, self.scale)


class GroupNorm(nn.Module):
    """Affine GroupNorm on NHWC tensors (params named as in the JAX
    package: ``scale``, ``bias``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return groupnorm(x, self.scale, self.bias)


def init_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``generator``: weights
    of ``nn.Linear`` (and :class:`Dense`) and :class:`Conv` ~ N(0,
    1/fan_in), biases zero."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
        elif isinstance(m, Conv):
            fan_in = m.weight[0].numel()
        else:
            continue
        with torch.no_grad():
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
