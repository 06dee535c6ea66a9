"""Flash attention forward on the card (CUDA C++, tensor cores).

Replaces the TPU kernel ``flash_attention`` (body ``_flash_kernel``) of
``repro/kernels/flash_attention.py``.  Source:
``csrc/flash_attention.cu``; plain version:
:func:`repro_torch.kernels.ref.flash_attention_ref`.

What bounds it on the card at the DiT-B/2 shapes (B=8, S=256, H=12,
D=64): operations — 4·B·H·S²·D ≈ 1.6 GFLOP of products against 25 MB
of q/k/v/o.  The products run on the tensor cores in TF32 with each
operand split into two TF32 halves (hi + lo, round to nearest) and
three products summed in f32 (lo·hi + hi·lo + hi·hi), which keeps f32
accuracy (the 2e-5 kernel tolerance) at three TF32 products per f32
one: the bound is 3·4·B·H·S²·D against 495 TFLOP/s dense TF32.  A warp
owns 16 query rows (``mma.sync`` m16n8k8) and keeps P in registers
between the two products; K/V tiles of 64 keys stream through a
two-stage ``cp.async`` ring in shared memory; at small batches the
warps of a block split the key tiles of the same rows and merge their
partial softmax sums, so that B=1 still fills the SMs (see the source).

bf16 q, k, v (flux-dev's MMDiT) take a kernel of their own in the same
source (``flash_attention_bf16_launch``), counted as
``flash_attention_bf16``: both products on the bf16 tensor cores
(``mma.sync`` m16n8k16, f32 accumulation), P rounded to bf16, the
softmax statistics in f32, the output written in bf16 — the TPU kernel
upcasts its bf16 tiles to f32 and casts its output back.  Bound:
operations, 4·B·H·S²·D against 989 TFLOP/s dense bf16.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
HEAD_DIMS_BF16 = (64, 128)
# dtype -> the launcher's C function and the head dims it takes
_ENTRY = {torch.float32: ("flash_attention_launch", HEAD_DIMS),
          torch.bfloat16: ("flash_attention_bf16_launch", HEAD_DIMS_BF16)}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib) -> None:
    lib.flash_attention_launch.argtypes = (
        [_P] * 4 + [_I] * 5 + [_P, ctypes.c_float, _I, _P])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_bf16_launch.argtypes = (
        [_P] * 4 + [_I] * 5 + [_P, ctypes.c_float, _I, _P])
    lib.flash_attention_bf16_launch.restype = ctypes.c_int
    lib.flash_attention_layout.argtypes = [_I] * 5 + [_P]
    lib.flash_attention_layout.restype = ctypes.c_int


def _lib():
    return _build.library("flash_attention", _declare)


def layout(b: int, h: int, sq: int, sk: int, d: int) -> dict:
    """The block layout the launcher picks for these sizes on the current
    card: ``row_groups`` x ``key_slots`` warps (16 query rows each; the
    key slots of a row group split its key tiles) and ``smem_bytes``."""
    out = (ctypes.c_longlong * 3)()
    _build.check(_lib().flash_attention_layout(b, h, sq, sk, d,
                                               ctypes.cast(out, _P)),
                 "flash_attention_layout")
    return dict(row_groups=out[0], key_slots=out[1], smem_bytes=out[2])


def launch(q, k, v, *, causal: bool = False):
    """K4: q (B, Sq, H, D), k/v (B, Sk, H, D) CUDA tensors, all float32 or
    all bfloat16, whose last axis is contiguous (strided views are fine;
    rows 16-byte aligned) -> contiguous (B, Sq, H, D) of the same dtype.
    float32 takes head dims ``HEAD_DIMS``, bfloat16 ``HEAD_DIMS_BF16``."""
    dtype = q.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    entry, head_dims = _ENTRY[dtype]
    align = 16 // q.element_size()      # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} like q, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, S, H, D) with a "
                             "contiguous last axis")
        if any(s % align for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned per row")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or k.shape[3] != d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in head_dims:
        raise ValueError(f"head dim {d} not in {head_dims} for {dtype}")
    if causal and sq > sk:
        raise ValueError("causal attention needs Sq <= Sk")
    out = torch.empty((b, sq, h, d), dtype=dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    stream = _build.stream(q)
    err = _build.launch(
        q, getattr(_lib(), entry), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, h, sq, sk, d,
        ctypes.cast(strides, _P), d ** -0.5, int(causal), stream)
    name = ("flash_attention" if dtype == torch.float32
            else "flash_attention_bf16")
    _build.check(err, name)
    kernels.count_launch(name, (b, sq, sk, h, d, int(causal)))
    return out
