"""Fused GroupNorm + SiLU on the card (CUDA C++), one launch per call.

``y = silu(groupnorm(x) * scale + bias)`` over an NHWC feature map — the
pre-convolution activation of every VAE resblock (two per block, so 12
calls per 256 px encode and 12 per decode).  Replaces the TPU kernel
``groupnorm_silu`` (body ``_gn_kernel``) of
``repro/kernels/groupnorm_silu.py``; source ``csrc/groupnorm_silu.cu``;
plain version :func:`repro_torch.kernels.ref.groupnorm_silu_ref`.

What bounds it on the card: memory — one read and one write of x
(2 x 268 MB at (8, 256, 256, 128) f32, 0.16 ms at 3.35 TB/s).  The TPU
kernel reduces one whole map per program in VMEM; here a thread-block
cluster per (batch element, slice of whole groups, 32 channels or 16
where a map has few slices) keeps its slice of x in shared memory while
the statistics are taken, merges its blocks' Welford partials through
distributed shared memory in a fixed order, and normalises from the
on-chip copy, all in one launch: x is read from device memory once
wherever the slice fits in the cluster (see the source for the size
rule).  No float
atomics, and a partition fixed by (H·W, C, groups) alone, so the bits
depend neither on the run nor on the batch.  CUDA C++ rather than
Triton: the launch goes through one ctypes call, a few microseconds of
host time, where the port's Triton launch path costs about 40 us.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
PLAN_KEYS = ("slice_channels", "slices", "cluster_blocks", "threads",
             "block_pixels", "thread_pixels", "thread_pixels_on_chip",
             "smem_bytes")


def _declare(lib) -> None:
    lib.groupnorm_silu_launch.argtypes = (
        [_P] * 4 + [_I] * 4 + [ctypes.c_float, _P])
    lib.groupnorm_silu_launch.restype = ctypes.c_int
    lib.groupnorm_silu_plan.argtypes = [_I, _I, _I, _P]
    lib.groupnorm_silu_plan.restype = None
    lib.groupnorm_silu_max_clusters.argtypes = [_I, _I, _I]
    lib.groupnorm_silu_max_clusters.restype = ctypes.c_int
    lib.groupnorm_silu_max_channels.argtypes = []
    lib.groupnorm_silu_max_channels.restype = ctypes.c_int


def _lib():
    return _build.library("groupnorm_silu", _declare)


def num_groups(channels: int, groups: int) -> int:
    """The group count actually used: ``min(groups, C)``, shrunk until it
    divides C (the JAX package's rule; C = 48 at groups 32 gives 24)."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def plan(hw: int, c: int, groups: int = 32) -> Dict[str, int]:
    """How the kernel partitions an (H·W, C) map (``PLAN_KEYS``), plus
    ``max_clusters``: how many of its clusters the card holds at once."""
    lib = _lib()
    g = num_groups(c, groups)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    lib.groupnorm_silu_plan(hw, c, g, ctypes.cast(out, _P))
    p = dict(zip(PLAN_KEYS, out))
    p["max_clusters"] = lib.groupnorm_silu_max_clusters(hw, c, g)
    return p


def launch(x, scale, bias, *, groups: int = 32, eps: float = 1e-5):
    """K6: x (B, H, W, C) contiguous float32 CUDA tensor, scale/bias (C,)
    float32 -> silu(groupnorm(x) * scale + bias), like x."""
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.device == scale.device == bias.device:
        raise ValueError("x, scale and bias must be on one device")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale/bias must be ({c},)")
    lib = _lib()
    if c % 4 or c > lib.groupnorm_silu_max_channels():
        raise ValueError(f"channels must be a multiple of 4 and at most "
                         f"{lib.groupnorm_silu_max_channels()}, got {c}")
    if not 1 <= b <= 65535 or h * w == 0:
        raise ValueError(f"need 1 <= batch <= 65535 and H*W > 0, got "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    stream = _build.stream(x)
    err = _build.launch(
        x, lib.groupnorm_silu_launch, x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h * w, c, num_groups(c, groups),
        eps, stream)
    _build.check(err, "groupnorm_silu")
    kernels.count_launch("groupnorm_silu", (b, h, w, c))
    return out
