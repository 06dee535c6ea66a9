"""Flash attention forward on the card (CUDA C++).

Replaces the TPU kernel ``flash_attention`` (body ``_flash_kernel``) of
``repro/kernels/flash_attention.py``.  Source:
``csrc/flash_attention.cu``; plain version:
:func:`repro_torch.kernels.ref.flash_attention_ref`.

What bounds it on the card at the DiT-B/2 shapes (B=8, S=256, H=12,
D=64): operations — 4·B·H·S²·D ≈ 1.6 GFLOP of f32 FMA against the
card's f32 rate; the (B, S, H, D) tensors are only 25 MB.  The TPU
kernel keeps the running max/sum/accumulator in VMEM across a
sequential key-block grid axis; here a block owns 64 query rows, keeps
them in registers and loops over the key axis itself, staging K/V tiles
in shared memory (see the source).  Plain FMA, no tensor cores yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 5 + [_P, ctypes.c_float, _I, _P])
        lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def launch(q, k, v, *, causal: bool = False):
    """K4: q (B, Sq, H, D), k/v (B, Sk, H, D) float32 CUDA tensors whose
    last axis is contiguous (strided views are fine) -> contiguous
    (B, Sq, H, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, S, H, D) with a "
                             "contiguous last axis")
        if any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned per row")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or k.shape[3] != d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if causal and sq > sk:
        raise ValueError("causal attention needs Sq <= Sk")
    out = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq,
        sk, d, ctypes.cast(strides, _P), d ** -0.5, int(causal), stream)
    _build.check(err, "flash_attention")
    kernels.LAUNCHES["flash_attention"] += 1
    return out
