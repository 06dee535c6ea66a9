"""Fused affine-free LayerNorm + adaLN modulation on the card (Triton).

``y = LN(x) * (1 + scale[b]) + shift[b]`` — the DiT block prologue,
called twice per block.  Replaces the TPU kernel ``adaln_modulate``
(body ``_adaln_kernel``) of ``repro/kernels/adaln.py``; plain version:
:func:`repro_torch.kernels.ref.adaln_modulate_ref`.

What bounds it on the card: memory — one read and one write of the
(B, T, D) activation (2 x 8·256·768·4 B ≈ 12.6 MB at DiT-B/2, B=8),
against a handful of operations per element.  The TPU kernel tiles
tokens through VMEM; here one Triton program owns one token row (D ≤ a
power-of-two block held in registers), computes the mean/variance in
f32 and writes the modulated row — one pass, no intermediate in device
memory.  ``triton`` is imported inside :func:`launch`, at first use, and
keeps its compile cache under the checkout's ``build/triton`` unless
``TRITON_CACHE_DIR`` says otherwise.
"""
import os

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

_JIT = {}
tl = None   # triton.language, bound at first use (the kernel resolves it
#             through this module's globals, where Triton looks names up)


def _kernel():
    """Build the ``@triton.jit`` function once per process."""
    global tl
    if "adaln" not in _JIT:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR.parent / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def _adaln_kernel(x_ptr, shift_ptr, scale_ptr, out_ptr, n_tokens, dim,
                          shift_sb, scale_sb, eps,
                          BLOCK_D: tl.constexpr):
            row = tl.program_id(0)                 # b * n_tokens + t
            b = row // n_tokens
            cols = tl.arange(0, BLOCK_D)
            mask = cols < dim
            x = tl.load(x_ptr + row * dim + cols, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / dim
            xc = tl.where(mask, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / dim
            rstd = 1.0 / tl.sqrt(var + eps)
            sh = tl.load(shift_ptr + b * shift_sb + cols, mask=mask, other=0.0)
            sc = tl.load(scale_ptr + b * scale_sb + cols, mask=mask, other=0.0)
            y = xc * rstd * (1.0 + sc) + sh
            tl.store(out_ptr + row * dim + cols, y, mask=mask)

        _JIT["adaln"] = (triton, _adaln_kernel)
    return _JIT["adaln"]


def launch(x, shift, scale, *, eps: float = 1e-5):
    """K5: x (B, T, D) contiguous float32 CUDA tensor; shift/scale (B, D)
    float32 whose last axis is contiguous (row-strided views such as the
    chunks of the DiT's adaLN projection are fine) -> (B, T, D)."""
    for name, t in (("x", x), ("shift", shift), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, T, D) tensor")
    b, t, d = x.shape
    for name, m in (("shift", shift), ("scale", scale)):
        if tuple(m.shape) != (b, d) or m.stride(1) != 1:
            raise ValueError(f"{name} must be (B, D) = {(b, d)} with a "
                             f"contiguous last axis, got {tuple(m.shape)}")
    triton, kernel = _kernel()
    out = torch.empty_like(x)
    block_d = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(b * t,)](x, shift, scale, out, t, d, shift.stride(0),
                         scale.stride(0), eps, BLOCK_D=block_d,
                         num_warps=4 if block_d <= 1024 else 8)
    kernels.count_launch("adaln_modulate", (b, t, d))
    return out
