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
* adaLN modulation (K5, ``csrc/adaln.cu``): one warp a token row, lane l
  holding float4 columns l, l + 32, ..; four column sums a lane (x, y,
  z, w) combined as (x + y) + (z + w), then a ``__shfl_xor`` butterfly,
  for the mean and for the centred variance.  Nothing depends on the batch, so a row gives the same bits
  alone and in a batch.
* Per-node scan (K1, ``csrc/vdb_topk.cu``, clustered): scores in the
  lanes' order, the launcher's partition of a node's capacity rows over a
  cluster's blocks (``vdb_topk.pernode_plan``), tiles of 32 candidates
  taken into a running top-32 by a warp bitonic sort and merge (skipped
  when no candidate beats the current k-th), and the blocks' lists merged
  in the fixed binary tree.  Slot ids must equal the Pallas kernel's
  exactly: exact ties straddling block boundaries, masked rows, an empty
  node, ragged chunks, k up to 32.

The emulations live here, not on the main path.  Tolerance: the kernel
tests' 2e-5 (``_torch_parity.KERNEL_TOL``)."""
from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KERNEL_TOL
from repro.kernels import ref as jref
from repro.kernels.adaln import adaln_modulate as jadaln
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.groupnorm_silu import groupnorm_silu as jgroupnorm_silu
from repro.kernels.vdb_topk import vdb_topk_pernode as jpernode
from repro_torch.kernels import adaln as tadaln
from repro_torch.kernels import vdb_topk as tvdb

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


# --------------------------------------------------------------------------
# shared: warp arithmetic on a trailing axis of 32 lanes
# --------------------------------------------------------------------------

LANES = torch.arange(32)


def fma(a, b, c):
    """fmaf: one rounding of a * b + c (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(s):
    """The fixed __shfl_xor tree: s_l + s_(l ^ off) for off = 16 .. 1."""
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., LANES ^ off]
    return s


def lanes_of(x, d4: int):
    """x (..., 4·d4) -> (..., NV, 32, 4): lane l's float4 columns l,
    l + 32, .. (zeros past the row), and the mask of real ones."""
    nv = -(-d4 // 32)
    pad = torch.zeros(x.shape[:-1] + (nv * 128,), dtype=x.dtype)
    pad[..., :4 * d4] = x
    real = (torch.arange(nv * 32) < d4).reshape(nv, 32)
    return pad.reshape(x.shape[:-1] + (nv, 32, 4)), real


# --------------------------------------------------------------------------
# K5: warp-per-row adaLN modulation
# --------------------------------------------------------------------------


def emulate_adaln(x, shift, scale, eps: float = 1e-5):
    """K5 on x (B, T, D) as ``adaln_rows`` computes each row."""
    b, t, d = x.shape
    v, real = lanes_of(x, d // 4)                    # (B, T, NV, 32, 4)
    sh, _ = lanes_of(shift[:, None], d // 4)          # (B, 1, NV, 32, 4)
    sc, _ = lanes_of(scale[:, None], d // 4)
    a = v[:, :, 0]                                    # (B, T, 32, 4)
    for j in range(1, v.shape[2]):
        a = a + v[:, :, j]
    s = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
    mean = butterfly(s)[..., :1] / d                  # every lane alike
    xc = v - mean[..., None, None]
    q = torch.zeros((b, t, 32, 4))
    for j in range(v.shape[2]):
        q = torch.where(real[j][:, None], fma(xc[:, :, j], xc[:, :, j], q),
                        q)
    s2 = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    var = butterfly(s2)[..., :1] / d
    rstd = 1.0 / torch.sqrt(var + eps)
    y = fma(xc * rstd[..., None, None], 1.0 + sc, sh)
    return y.reshape(b, t, -1)[..., :d]


def _adaln_inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, t, d)) * 2 + 0.5).astype(np.float32)
    ada = rng.normal(size=(b, 6 * d)).astype(np.float32)
    return x, ada[:, :d].copy(), ada[:, d:2 * d].copy()


@pytest.mark.parametrize("b,t,d", [
    (2, 16, 768),      # DiT-B/2 width: 6 float4 a lane, no masked lane
    (1, 5, 1152),      # DiT-XL: 9 float4 a lane
    (3, 7, 100),       # 25 float4: 7 lanes masked
    (2, 3, 1536)])     # the kernel's widest row, 12 float4 a lane
def test_adaln_emulation_matches_pallas(b, t, d):
    x, sh, sc = _adaln_inputs(b, t, d, seed=b * t + d)
    want = np.asarray(jadaln(*map(jnp.asarray, (x, sh, sc)),
                             interpret=True))
    got = emulate_adaln(*map(torch.from_numpy, (x, sh, sc)))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_adaln_row_bits_do_not_depend_on_the_batch():
    x, sh, sc = (torch.from_numpy(a) for a in _adaln_inputs(4, 9, 768, 3))
    batch = emulate_adaln(x, sh, sc)
    for i in range(4):
        assert torch.equal(emulate_adaln(x[i:i + 1], sh[i:i + 1],
                                         sc[i:i + 1]), batch[i:i + 1])
    assert torch.equal(emulate_adaln(x[:, 5:6], sh, sc), batch[:, 5:6])


@pytest.mark.parametrize("rows,want", [(256, 2), (512, 2), (1024, 2),
                                       (2048, 4)])
def test_adaln_block_size_rule(rows, want):
    """Two warps (rows) a block up to B=4 of DiT-B/2 (256 rows fill 128
    blocks), four above."""
    assert tadaln.warps_per_block(rows) == want


# --------------------------------------------------------------------------
# K1: clustered per-node scan
# --------------------------------------------------------------------------

EMPTY_SLOT = 2 ** 31 - 1


def lane_scores(q, slabs):
    """(P, N, Q, cap) cosine scores as both scan paths form them: lane l
    runs fmaf over the float4 columns l, l + 32, .. (x, y, z, w), then
    the butterfly."""
    d4 = slabs.shape[-1] // 4
    rv, _ = lanes_of(slabs, d4)                      # (P, N, cap, NV, 32, 4)
    qv, _ = lanes_of(q, d4)                          # (Q, NV, 32, 4)
    rv = rv[:, :, None]                              # (P, N, 1, cap, ...)
    qv = qv[None, None, :, None]                     # (1, 1, Q, 1, ...)
    acc = torch.zeros(rv.shape[:3] + (slabs.shape[2], 32))
    acc = acc.expand(slabs.shape[0], slabs.shape[1], q.shape[0], -1,
                     -1).contiguous()
    for j in range(rv.shape[-3]):
        for c in range(4):
            acc = fma(rv[..., j, :, c], qv[..., j, :, c], acc)
    return butterfly(acc)[..., 0]


def better(s1, i1, s2, i2):
    return (s1 > s2) | ((s1 == s2) & (i1 < i2))


def cmpx(s, i, stride: int, keep_better):
    ps, pi = s[..., LANES ^ stride], i[..., LANES ^ stride]
    take = torch.where(keep_better, better(ps, pi, s, i),
                       better(s, i, ps, pi))
    return torch.where(take, ps, s), torch.where(take, pi, i)


def warp_sort(s, i):
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            s, i = cmpx(s, i, stride, ((LANES & stride) == 0)
                        == ((LANES & size) == 0))
            stride //= 2
        size *= 2
    return s, i


def warp_merge(ls, li, cs, ci):
    rs, ri = cs[..., 31 - LANES], ci[..., 31 - LANES]
    take = better(rs, ri, ls, li)
    ls, li = torch.where(take, rs, ls), torch.where(take, ri, li)
    for stride in (16, 8, 4, 2, 1):
        ls, li = cmpx(ls, li, stride, (LANES & stride) == 0)
    return ls, li


def emulate_pernode(q, slabs, valid, k: int):
    """K1 as ``pernode_fused`` computes it, every (plane, node, query) at
    once: the plan's blocks scan their chunks tile by tile, then the
    blocks' top-k lists merge in the binary tree."""
    n_idx, n_nodes, cap, d = slabs.shape
    plan = tvdb.pernode_plan(q.shape[0], cap, d)
    scores = lane_scores(q, slabs)
    nodes = torch.arange(n_nodes)[None, :, None, None]
    lead = scores.shape[:3]
    lists = []
    for r in range(plan["cluster_blocks"]):
        r0 = min(r * plan["block_rows"], cap)
        r1 = min(r0 + plan["block_rows"], cap)
        ls = torch.full(lead + (32,), float("-inf"))
        li = torch.full(lead + (32,), EMPTY_SLOT, dtype=torch.int64)
        for t, a in enumerate(range(r0, r1, 32)):
            cols = a + LANES
            inb = cols < r1
            col = cols.clamp(max=cap - 1)
            ok = valid[:, col][None, :, None, :]
            cs = torch.where(inb, torch.where(ok, scores[..., col],
                                              torch.tensor(-1e30)),
                             float("-inf"))
            ci = torch.where(inb, nodes * cap + cols,
                             EMPTY_SLOT).expand(lead + (32,))
            take = better(cs, ci, ls[..., k - 1:k],
                          li[..., k - 1:k]).any(-1, keepdim=True)
            ss, si = warp_sort(cs, ci)
            ms, mi = (ss, si) if t == 0 else warp_merge(ls, li, ss, si)
            ls, li = torch.where(take, ms, ls), torch.where(take, mi, li)
        keep = LANES < k                 # a block shares its top-k only
        lists.append((torch.where(keep, ls, float("-inf")),
                      torch.where(keep, li, EMPTY_SLOT)))
    while len(lists) > 1:
        lists = [warp_merge(*lists[w], *lists[w + 1]) if w + 1 < len(lists)
                 else lists[w] for w in range(0, len(lists), 2)]
    s, i = lists[0]
    return s[..., :k], i[..., :k].to(torch.int32)


def _pernode_case(qn, nodes, cap, d, *, ties: bool, seed: int):
    """``ties``: integer vectors, with every block's chunk repeating the
    rows of the chunk before it, so equal scores straddle each block
    boundary and are exact in any order; node 1 empty, other rows valid
    with probability 0.7."""
    rng = np.random.default_rng(seed)
    if ties:
        slabs = rng.integers(-1, 2, size=(2, nodes, cap, d)).astype(
            np.float32)
        rows = tvdb.pernode_plan(qn, cap, d)["block_rows"]
        for a in range(rows, cap, rows):
            n = min(rows, cap - a)
            slabs[:, :, a:a + n] = slabs[:, :, a - rows:a - rows + n]
        q = rng.integers(-1, 2, size=(qn, d)).astype(np.float32)
    else:
        slabs = rng.normal(size=(2, nodes, cap, d)).astype(np.float32)
        slabs /= np.linalg.norm(slabs, axis=-1, keepdims=True)
        q = rng.normal(size=(qn, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    valid = rng.random((nodes, cap)) < 0.7
    valid[1] = False
    return q, slabs, valid


@pytest.mark.parametrize("qn,cap,d,k", [
    (3, 70, 64, 8),        # 3 blocks of 24, 24 and 22 rows: ragged chunks
    (5, 300, 192, 32),     # 8 blocks of 38 rows: two tiles a block; k = 32
    (1, 100, 16, 1),       # 4 blocks of 25; k = 1
    (17, 40, 32, 5)])      # two query tiles; 2 blocks of 20 rows
@pytest.mark.parametrize("ties", [True, False])
def test_pernode_emulation_matches_pallas(qn, cap, d, k, ties):
    """Real hits: the Pallas kernel's slots and scores.  Every position,
    masked ones included: the JAX package's oracle's slots (the Pallas
    kernel leaves slot 0 behind its -1e30 sentinel where a node has
    fewer than k valid rows), with -inf where the clustered scan has
    -1e30."""
    q, slabs, valid = _pernode_case(qn, 3, cap, d, ties=ties,
                                    seed=qn * 7 + cap + k)
    want_s, want_i = (np.asarray(a) for a in jpernode(
        *map(jnp.asarray, (q, slabs, valid)), k, interpret=True))
    got_s, got_i = (a.numpy() for a in emulate_pernode(
        *map(torch.from_numpy, (q, slabs, valid)), k))
    hit = want_s > -1e29
    np.testing.assert_array_equal(got_s > -1e29, hit)
    np.testing.assert_array_equal(got_i[hit], want_i[hit])
    np.testing.assert_allclose(got_s, want_s, **KERNEL_TOL)
    ref_s, ref_i = (np.asarray(a) for a in jref.vdb_topk_pernode_ref(
        *map(jnp.asarray, (q, slabs, valid)), k))
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(np.isneginf(ref_s), got_s <= -1e29)


def test_pernode_scores_are_the_lane_order_sums():
    """Scores within f32 rounding of the plain matmul."""
    q, slabs, valid = _pernode_case(4, 2, 50, 192, ties=False, seed=1)
    got = lane_scores(torch.from_numpy(q), torch.from_numpy(slabs))
    want = torch.einsum("qd,incd->inqc", torch.from_numpy(q),
                        torch.from_numpy(slabs))
    torch.testing.assert_close(got, want, rtol=0, atol=KERNEL_TOL["atol"])


@pytest.mark.parametrize("qn,cap,d,want", [
    (8, 400, 512, dict(query_tile=8, cluster_blocks=8, block_rows=50,
                       stages=2)),
    (1, 400, 512, dict(query_tile=1, cluster_blocks=8, block_rows=50,
                       stages=2)),
    (3, 63, 512, dict(query_tile=4, cluster_blocks=2, block_rows=32,
                      stages=1)),
    (17, 4096, 512, dict(query_tile=16, cluster_blocks=8, block_rows=512,
                         stages=2)),
    (8, 1, 4, dict(query_tile=8, cluster_blocks=1, block_rows=1,
                   stages=1))])
def test_pernode_plan(qn, cap, d, want):
    """The serving fleet's 4 nodes x 400 slots take clusters of 8 blocks
    of 50 rows (64 SMs, one wave); every plan covers the capacity and
    fits a block's shared memory."""
    got = tvdb.pernode_plan(qn, cap, d)
    assert {key: got[key] for key in want} == want
    assert got["cluster_blocks"] * got["block_rows"] >= cap
    assert got["smem_bytes"] <= tvdb.SMEM_LIMIT
    with pytest.raises(ValueError, match="too wide"):
        tvdb.pernode_plan(16, 64, 4096)
