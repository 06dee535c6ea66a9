"""Fused affine-free LayerNorm + adaLN modulation on the card (CUDA C++).

``y = LN(x) * (1 + scale[b]) + shift[b]`` — the DiT block prologue,
called twice per block (24 calls per DiT-B/2 forward).  Replaces the TPU
kernel ``adaln_modulate`` (body ``_adaln_kernel``) of
``repro/kernels/adaln.py``; source ``csrc/adaln.cu``; plain version:
:func:`repro_torch.kernels.ref.adaln_modulate_ref`.

What bounds it on the card: memory — one read and one write of the
(B, T, D) activation (2 x 256·768·4 B = 1.6 MB at DiT-B/2, B=1; 0.47 us
at 3.35 TB/s), against a handful of operations per element.  The TPU
kernel tiles tokens through VMEM; here one warp owns a token row, holds
it in registers as float4s, takes the mean and the centred variance with
fixed warp-shuffle trees (the bits of a row do not depend on the batch)
and writes the modulated row: one pass, no shared memory, no block
barrier.  :func:`warps_per_block` picks the block size from the number
of rows.  CUDA C++ rather than Triton: one ctypes call, no Python
launcher and no device context per call (PERF.md gives both per-call
times).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
MAX_DIM = 1536                 # 12 float4 a lane (csrc/adaln.cu MAX_NV)


def _declare(lib) -> None:
    lib.adaln_launch.argtypes = ([_P] * 4 + [_I] * 3 + [_L] * 2
                                 + [_I, ctypes.c_float, _P])
    lib.adaln_launch.restype = ctypes.c_int


def _lib():
    return _build.library("adaln", _declare)


def warps_per_block(rows: int) -> int:
    """Warps (rows) a block for ``rows`` = B·T token rows: two up to 1024
    rows, so that one DiT-B/2 image (256 rows) spreads over 128 blocks,
    four above (the sweep in ``tools/kernel_diag.py``)."""
    return 2 if rows <= 1024 else 4


def _refuse(x, shift, scale):
    for name, t in (("x", x), ("shift", shift), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _row_view(name, m, b, d):
    """(data pointer, row stride) of a (B, D) view with a contiguous last
    axis, 16-byte aligned, whose row stride is a multiple of 4."""
    st, ptr = m.stride(), m.data_ptr()
    if m.shape != (b, d) or st[1] != 1:
        raise ValueError(f"{name} must be (B, D) = {(b, d)} with a "
                         f"contiguous last axis, got {tuple(m.shape)}")
    if st[0] % 4 or ptr % 16:
        raise ValueError(f"{name} must be 16-byte aligned with a row "
                         f"stride that is a multiple of 4")
    return ptr, st[0]


def launch(x, shift, scale, *, eps: float = 1e-5):
    """K5: x (B, T, D) contiguous float32 CUDA tensor; shift/scale (B, D)
    float32 whose last axis is contiguous (row-strided views such as the
    chunks of the DiT's adaLN projection are fine) -> (B, T, D).  D must
    be a multiple of 4 and at most ``MAX_DIM``; every pointer 16-byte
    aligned and every row stride a multiple of 4.  The checks take the
    fewest tensor attribute reads that decide them: at B=1 the host's
    time per call is most of what a caller waits for."""
    f32 = torch.float32
    if not (x.is_cuda and shift.is_cuda and scale.is_cuda and x.dtype == f32
            and shift.dtype == f32 and scale.dtype == f32):
        _refuse(x, shift, scale)
    if not x.get_device() == shift.get_device() == scale.get_device():
        raise ValueError("x, shift and scale must be on one device")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, T, D) tensor")
    b, t, d = x.shape
    if d % 4 or not 0 < d <= MAX_DIM:
        raise ValueError(f"D must be a multiple of 4 and at most {MAX_DIM}, "
                         f"got {d}")
    sh_ptr, sh_sb = _row_view("shift", shift, b, d)
    sc_ptr, sc_sb = _row_view("scale", scale, b, d)
    x_ptr = x.data_ptr()
    if b * t == 0 or x_ptr % 16:
        raise ValueError("x must be non-empty and 16-byte aligned")
    out = torch.empty_like(x)
    err = _build.launch(
        x, _lib().adaln_launch, x_ptr, sh_ptr, sc_ptr, out.data_ptr(), b,
        t, d, sh_sb, sc_sb, warps_per_block(b * t), eps, _build.stream(x))
    _build.check(err, "adaln_modulate")
    kernels.count_launch("adaln_modulate", (b, t, d))
    return out
