"""The numerics the port's redesigned kernels rest on, emulated in plain
PyTorch on the CPU and held against the JAX package's Pallas kernels
(interpret mode), at small sizes with inputs from numpy seeds.

* Flash attention (K4, ``csrc/flash_attention.cu``): every product on the
  tensor cores as three TF32 products (3xTF32: x = hi + lo, both rounded
  to nearest to a 10-bit mantissa; lo.hi + hi.lo + hi.hi summed in f32),
  softmax in base 2 online over 64-key tiles, and the key-slot split of
  small batches, whose partial (max, sum, accumulator) merge in slot
  order.  A single TF32 product is shown to miss the tolerance.
* GroupNorm + SiLU (K6, ``csrc/groupnorm_silu.cu``): the kernel's
  partition of a map (slices of whole groups, a cluster of blocks per
  slice, pixel lanes per block, the part of a block's chunk kept on
  chip), per-thread Welford in the kernel's order, and the fixed binary
  merge trees (Chan's formula) over lanes, channels and the cluster's
  blocks.  The partition depends on (H·W, C, groups) only, so an image
  gives the same bits alone and in a batch.

The emulations live here, not on the main path.  Tolerance: the kernel
tests' 2e-5 (``_torch_parity.KERNEL_TOL``)."""
from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KERNEL_TOL
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.groupnorm_silu import groupnorm_silu as jgroupnorm_silu

LOG2E = 1.4426950408889634
MASKED = -1e30

# --------------------------------------------------------------------------
# K4: 3xTF32 flash attention
# --------------------------------------------------------------------------


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 as the kernel does it on the bits: add half an ulp
    of the 10-bit mantissa to the magnitude, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b with both operands split; lo.hi + hi.lo + hi.hi in f32, the
    small terms first (``terms=1``: hi.hi alone, a single TF32 product)."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulate_flash(q, k, v, *, causal: bool, key_slots: int = 1,
                  terms: int = 3, bk: int = 64):
    """(B, Sq, H, D) attention as K4 computes it: q pre-scaled by
    log2(e)/sqrt(D), online softmax in base 2 over key tiles of ``bk``;
    slot s of ``key_slots`` takes tiles s, s + key_slots, .. and the
    slots' partials merge in slot order."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = (q * (d ** -0.5 * LOG2E)).permute(0, 2, 1, 3)      # (B, H, Sq, D)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    rows = torch.arange(sq)[:, None]
    n_tiles = -(-sk // bk)
    parts = []
    for slot in range(key_slots):
        m = torch.full((b, h, sq, 1), MASKED)
        l = torch.zeros((b, h, sq, 1))
        acc = torch.zeros((b, h, sq, d))
        for t in range(slot, n_tiles, key_slots):
            k0 = t * bk
            s = mm_3xtf32(qs, kt[:, :, k0:k0 + bk].transpose(-1, -2), terms)
            cols = k0 + torch.arange(s.shape[-1])[None, :]
            ok = cols < sk
            if causal:
                ok = ok & (rows + sk - sq >= cols)
            s = torch.where(ok, s, MASKED)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm_3xtf32(p, vt[:, :, k0:k0 + bk], terms)
            m = m_new
        parts.append((m, l, acc))
    m, l, acc = parts[0]
    for mo, lo, acco in parts[1:]:
        m_new = torch.maximum(m, mo)
        ca, cb = torch.exp2(m - m_new), torch.exp2(mo - m_new)
        l, acc, m = l * ca + lo * cb, acc * ca + acco * cb, m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32)
            for n in (sq, sk, sk)]


def test_rna_tf32_rounds_to_nearest_ten_bit_mantissa():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 50
    got = rna_tf32(torch.from_numpy(x)).numpy()
    mant, exp = np.frexp(x.astype(np.float64))       # |mant| in [0.5, 1)
    want = np.sign(mant) * np.floor(np.abs(mant) * 2048 + 0.5) / 2048
    np.testing.assert_array_equal(got, np.ldexp(want, exp).astype(np.float32))
    hi, lo = split(torch.from_numpy(x))
    # hi + lo carries 21 bits of x: within 2^-22 of it, relatively
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), x,
                               rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 64, 64, 2, 32), (1, 70, 130, 2, 64), (1, 33, 47, 1, 128),
    (2, 1, 96, 3, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key_slots", [1, 2, 4])
def test_3xtf32_flash_matches_pallas(b, sq, sk, h, d, causal, key_slots):
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq * 31 + d)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                             interpret=True))
    got = emulate_flash(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        key_slots=key_slots)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_single_tf32_product_misses_the_tolerance():
    """Why the split: at the DiT's head dim one TF32 product per f32 one
    is off by far more than 2e-5; three are well inside it."""
    q, k, v = _qkv(1, 128, 128, 2, 64, seed=5)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    err1 = np.abs(emulate_flash(*args, causal=False, terms=1).numpy()
                  - want).max()
    err3 = np.abs(emulate_flash(*args, causal=False).numpy() - want).max()
    assert err1 > 10 * KERNEL_TOL["atol"]
    assert err3 < KERNEL_TOL["atol"] / 4


# --------------------------------------------------------------------------
# K6: one-launch GroupNorm + SiLU
# --------------------------------------------------------------------------

MAX_CLUSTER, MIN_BLOCK_PX = 16, 256
TILE_SHARED, TILE_ALONE = 92 * 1024, 160 * 1024


def num_groups(c: int, groups: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def slice_channels(c: int, cg: int, want: int) -> int:
    want = min(want, c)
    for d in range(4, c, 4):
        if c % d == 0 and d % cg == 0 and d >= want:
            return d
    return c


def plan(hw: int, c: int, g: int) -> dict:
    """The kernel's ``make_plan``: a function of (H·W, C, groups) only."""
    cg = c // g
    cs32, cs16 = slice_channels(c, cg, 32), slice_channels(c, cg, 16)
    max_threads, tile, cs = 512, TILE_SHARED, cs32
    if c // cs32 <= 4:
        if cs16 < cs32 and hw * cs16 * 4 <= MAX_CLUSTER * TILE_SHARED:
            cs = cs16
        else:
            max_threads, tile = 1024, TILE_ALONE
    q4 = cs // 4
    cl = min(MAX_CLUSTER, max(1, -(-hw // MIN_BLOCK_PX)))
    chunk = -(-hw // cl)
    threads = 256
    while threads < max_threads and chunk * q4 > 8 * threads:
        threads *= 2
    lanes = threads // q4
    kmax = -(-chunk // lanes)
    return dict(cs=cs, slices=c // cs, cl=cl, threads=threads, chunk=chunk,
                lanes=lanes, kmax=kmax,
                kcap=min(kmax, tile // (threads * 16)))


def chan_merge(a, b):
    """The kernel's branch-free Chan merge of (n, mean, m2) tensors."""
    n, mean, m2 = a
    nb, meanb, m2b = b
    tot = n + nb
    wb = nb / torch.clamp(tot, min=1.0)
    delta = meanb - mean
    mean_m = mean + delta * wb
    m2_m = m2 + m2b + delta * delta * n * wb
    empty = n == 0
    return tot, torch.where(empty, meanb, mean_m), torch.where(empty, m2b,
                                                               m2_m)


def tree(stats, axis: int):
    """Fixed binary tree along ``axis`` (index l takes in l + s when
    l % 2s == 0), the kernel's shuffle and shared-memory trees."""
    n = stats[0].shape[axis]
    s = 1
    while s < n:
        lo = [t.narrow(axis, 0, n).clone() for t in stats]
        idx = torch.arange(0, n - s, 2 * s)
        a = [t.index_select(axis, idx) for t in lo]
        b = [t.index_select(axis, idx + s) for t in lo]
        merged = chan_merge(a, b)
        for t, m in zip(lo, merged):
            t.index_copy_(axis, idx, m)
        stats = lo
        s *= 2
    return [t.select(axis, 0) for t in stats]


def emulate_groupnorm_silu(x, scale, bias, *, groups: int = 32,
                           eps: float = 1e-5):
    """K6 on x (B, H, W, C): per (image, slice) cluster, per block chunk,
    per thread (lane, float4 of channels) a Welford over its pixels (the
    ones read from global memory first, then the on-chip ones), then the
    trees over lanes, a group's channels and the blocks."""
    b, hh, ww, c = x.shape
    hw = hh * ww
    g = num_groups(c, groups)
    cg = c // g
    p = plan(hw, c, g)
    cs, lanes, cl = p["cs"], p["lanes"], p["cl"]
    xf = x.reshape(b, hw, c)
    out = torch.empty_like(xf)
    for sl in range(p["slices"]):
        ch = slice(sl * cs, (sl + 1) * cs)
        parts = []                       # per block: (n, mean, m2) (B, cs)
        for r in range(cl):
            p0, p1 = r * p["chunk"], min((r + 1) * p["chunk"], hw)
            n = torch.zeros((b, lanes, 1))
            mean = torch.zeros((b, lanes, cs))
            m2 = torch.zeros((b, lanes, cs))
            order = list(range(p["kcap"], p["kmax"])) + list(range(p["kcap"]))
            for k in order:
                px = p0 + torch.arange(lanes) + k * lanes
                live = (px < p1)[None, :, None]
                v = xf[:, torch.clamp(px, max=hw - 1), ch]
                n_new = torch.where(live, n + 1, n)
                d = v - mean
                mean = torch.where(live, mean + d / torch.clamp(n_new, min=1),
                                   mean)
                m2 = torch.where(live, m2 + d * (v - mean), m2)
                n = n_new
            bn, bmean, bm2 = tree([n.expand(-1, -1, cs), mean, m2], axis=1)
            gstat = tree([t.reshape(b, cs // cg, cg).transpose(1, 2)
                          for t in (bn, bmean, bm2)], axis=1)
            parts.append(gstat)           # (B, groups of the slice)
        gn, gmean, gm2 = tree([torch.stack(t, dim=1) for t in zip(*parts)],
                              axis=1)
        rstd = torch.rsqrt(gm2 / gn + eps)
        a = (rstd.repeat_interleave(cg, dim=1) * scale[ch])[:, None]
        sh = bias[ch] - gmean.repeat_interleave(cg, dim=1)[:, None] * a
        y = xf[:, :, ch] * a + sh
        out[:, :, ch] = y / (1 + torch.exp(-y))
    return out.reshape(b, hh, ww, c)


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.normal(1.0, 0.3, size=(c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.3, size=(c,)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,groups", [
    ((2, 32, 32, 64), 32),     # 16-channel slices, 4 blocks a cluster
    ((1, 24, 24, 128), 32),    # a cluster of 3 blocks
    ((1, 32, 32, 48), 32),     # the shrink rule: 24 groups of 2
    ((2, 20, 20, 64), 8),      # the reduced configs' groups=8
    ((3, 9, 7, 64), 8),        # one block, a ragged lane
    ((1, 16, 16, 256), 32)])   # 32-channel slices, one block
def test_groupnorm_silu_emulation_matches_pallas(shape, groups):
    x, scale, bias = _gn_inputs(shape, seed=shape[-1] + groups + shape[1])
    want = np.asarray(jgroupnorm_silu(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), groups=groups,
                                      interpret=True))
    got = emulate_groupnorm_silu(*map(torch.from_numpy, (x, scale, bias)),
                                 groups=groups)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_groupnorm_silu_same_bits_alone_and_in_a_batch():
    x, scale, bias = (torch.from_numpy(a)
                      for a in _gn_inputs((3, 32, 32, 64), seed=9))
    batch = emulate_groupnorm_silu(x, scale, bias)
    for i in range(3):
        assert torch.equal(
            emulate_groupnorm_silu(x[i:i + 1], scale, bias), batch[i:i + 1])


@pytest.mark.parametrize("hw,c,want", [
    (128, 128, dict(cs=16, slices=8, cl=16, threads=512, kmax=8, kcap=8)),
    (64, 256, dict(cs=32, slices=8, cl=16, threads=256, kmax=8, kcap=8)),
    (32, 512, dict(cs=32, slices=16, cl=4, threads=256, kmax=8, kcap=8)),
    (64, 512, dict(cs=32, slices=16, cl=16, threads=256, kmax=8, kcap=8)),
    (128, 256, dict(cs=32, slices=8, cl=16, threads=512, kmax=16, kcap=11)),
    (256, 128, dict(cs=32, slices=4, cl=16, threads=1024, kmax=32,
                    kcap=10))])
def test_groupnorm_silu_plan_of_the_vae_shapes(hw, c, want):
    """Which resblock shapes stay on chip (kcap == kmax) and which read
    part of their chunk twice."""
    got = plan(hw * hw, c, 32)
    assert {k: got[k] for k in want} == want
