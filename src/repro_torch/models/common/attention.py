"""Scaled dot-product attention over (B, S, H, D) tensors — the
attention of the DiT, the MMDiT and the text encoder (the JAX package's
``repro/models/common/attention.py::sdpa``).

``use_pallas=True`` (the port's default) goes to the flash-attention
kernel through :func:`repro_torch.kernels.ops.flash_attention`, which
takes the plain version for CPU tensors; on the card float32 tensors
launch K4's float32 kernel and bfloat16 tensors (the MMDiT at full
width) its bfloat16 kernel.  ``False`` runs the plain version on any
device.  The JAX package's chunked path for sequences of 8192 and more
is not ported: the longest sequence here is flux-dev's 4352 tokens.
"""
from repro_torch.kernels import ops, ref


def sdpa(q, k, v, *, causal: bool, use_pallas: bool = True):
    """Scaled dot-product attention over (B, S, H, D) tensors."""
    if use_pallas:
        return ops.flash_attention(q, k, v, causal=causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)
