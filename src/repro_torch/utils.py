"""Small shared utilities (the numpy-only subset the port needs)."""
from __future__ import annotations

import numpy as np


def l2n(x, axis: int = -1):
    """L2-normalise along ``axis`` with the project-wide 1e-12 floor."""
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, 1e-12)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1).  The serving backend pads
    generation groups to these buckets, as the JAX package does."""
    b = 1
    while b < n:
        b *= 2
    return b


def stable_hash(s: str, mod: int) -> int:
    """Deterministic (process-independent) string hash into [0, mod)."""
    h = 1469598103934665603  # FNV-1a 64-bit
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h % mod
