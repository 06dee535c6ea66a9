"""The port's hand-written kernels against their plain versions on the
card, at shapes the smoke run does not cover (ragged tiles, k at its
limits, other head dims).  Marked ``cuda``: they skip without a GPU.

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance 2e-5 (f32 against f32); slot ids equal (the inputs are
integer-valued, so every score and every tie is exact).  The tests leave
PyTorch's float flags as they find them: the port sets its own precision
(``DiffusionBackend`` turns TF32 off on the card).

The last tests cover the front door's threads: a backend built under
PyTorch's default flags (cuDNN TF32 on) holds the VAE to the CPU, a
gateway serves from its worker thread the images a main-thread
``serve_group`` gives, and the kernels' libraries and ticket buffers are
made once whichever threads ask first."""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import (adaln, flash_attention, groupnorm_silu, ops,
                                 ref, vdb_topk)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-5, atol=2e-5)
# K4 at bf16 against its plain version (tests/test_kernels.py's bf16
# tolerance): P rounds to bf16 in both, at different points
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _scan_case(dev, qn, nodes, cap, d, seed):
    g = torch.Generator().manual_seed(seed)
    slabs = torch.randint(-2, 3, (2, nodes, cap, d), generator=g).float()
    slabs[:, :, cap // 2:] = slabs[:, :, :cap - cap // 2]   # exact ties
    q = torch.randint(-2, 3, (qn, d), generator=g).float()
    valid = torch.rand((nodes, cap), generator=g) < 0.6
    valid[0] = False                                        # empty node
    nids = torch.randint(0, nodes, (qn,), generator=g, dtype=torch.int32)
    return [t.to(dev) for t in (q, slabs, valid, nids)]


def _same_topk(got, want):
    s_k, i_k = got
    s_p, i_p = want
    masked = torch.isneginf(s_p)
    assert bool((s_k[masked] <= -1e29).all())
    torch.testing.assert_close(s_k[~masked], s_p[~masked], **TOL)
    assert torch.equal(i_k, i_p)


@pytest.mark.parametrize("qn,nodes,cap,d,k", [
    (1, 1, 1, 4, 1), (4, 4, 400, 512, 8), (8, 4, 400, 512, 8),
    (17, 3, 130, 64, 32), (40, 2, 64, 128, 5)])
def test_vdb_topk_kernels_match_plain(dev, qn, nodes, cap, d, k):
    q, slabs, valid, nids = _scan_case(dev, qn, nodes, cap, d, qn + cap)
    _same_topk(vdb_topk.launch_pernode(q, slabs, valid, k),
               ref.vdb_topk_pernode_ref(q, slabs, valid, k))
    for mask in (True, False):
        _same_topk(vdb_topk.launch_sharded(q, slabs, valid, nids, k,
                                           mask_nodes=mask),
                   ref.vdb_topk_sharded_ref(q, slabs, valid, nids, k,
                                            mask_nodes=mask))


@pytest.mark.parametrize("qn,n,d,k,empty", [
    (1, 1, 4, 1, False), (3, 400, 512, 8, False), (5, 400, 512, 8, False),
    (8, 400, 512, 8, False), (8, 400, 512, 8, True),
    (5, 30, 16, 30, False), (17, 130, 64, 32, False)])
def test_vdb_topk_single_matches_plain(dev, qn, n, d, k, empty):
    q, slabs, valid, _ = _scan_case(dev, qn, 2, n, d, qn + n + d)
    db = slabs[0, 1]                       # node 0 of a case is empty
    valid = valid[1] if not empty else valid[0]
    _same_topk(vdb_topk.launch_single(q, db, valid, k),
               ref.vdb_topk_ref(q, db, valid, k))


def _fill_case(dev, qn, nodes, cap, d, seed):
    """_scan_case with node 1 cut to 3 valid rows (fewer than k) and node
    ids that include the empty node 0, node 1 and ids outside [0, N)."""
    q, slabs, valid, _ = _scan_case(dev, qn, nodes, cap, d, seed)
    valid[1] = False
    valid[1, torch.tensor([0, cap // 2, cap - 1])] = True
    nids = (torch.arange(qn, dtype=torch.int32) % (nodes + 2) - 1).to(dev)
    return q, slabs, valid, nids


@pytest.mark.parametrize("cap,d", [(9, 16), (400, 512), (4096, 128)])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("qn", [1, 2, 4, 8, 17])
@pytest.mark.parametrize("mask", [True, False])
def test_vdb_topk_sharded_fill_rule_matches_plain(dev, mask, qn, k, cap, d):
    """K2 where lists run out of real candidates: the masked fill of a
    node with fewer than k valid rows (other nodes' slots in ascending
    order, read from no slab), an empty node, node ids outside [0, N),
    two query tiles (Q = 17), k up to 32 (above a node's capacity of 9)
    and 4096 slots a node; exact ties; the same bits on a second run (the
    global scan's tickets start from zero every launch)."""
    q, slabs, valid, nids = _fill_case(dev, qn, 4, cap, d, qn * 7 + cap + k)
    got = vdb_topk.launch_sharded(q, slabs, valid, nids, k, mask_nodes=mask)
    _same_topk(got, ref.vdb_topk_sharded_ref(q, slabs, valid, nids, k,
                                             mask_nodes=mask))
    again = vdb_topk.launch_sharded(q, slabs, valid, nids, k,
                                    mask_nodes=mask)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("n,d", [(400, 512), (1025, 64), (4096, 128)])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("qn", [1, 4, 8, 17])
def test_vdb_topk_single_fill_rule_matches_plain(dev, qn, k, n, d):
    """K3 on the clustered scan: a db with 3 valid rows (the list ends in
    masked rows by row id), two query tiles, k up to 32; 1025 and 4096
    rows split into nodes (the last one short at 1025) and merged."""
    q, slabs, valid, _ = _fill_case(dev, qn, 2, n, d, qn + n + k)
    db, ok = slabs[1, 1], valid[1]
    _same_topk(vdb_topk.launch_single(q, db, ok, k),
               ref.vdb_topk_ref(q, db, ok, k))


def test_vdb_topk_sharded_and_single_are_one_launch(dev):
    """K2 (both modes) and K3: scan, fill and merges in one kernel, with no
    allocation the graph would capture: one call is one graph node."""
    for qn, cap, d, k in ((8, 400, 512, 8), (1, 400, 512, 5),
                          (17, 130, 64, 32), (3, 4096, 128, 8)):
        q, slabs, valid, nids = _fill_case(dev, qn, 4, cap, d, cap)
        for mask in (True, False):
            assert _kernels_per_call(lambda: vdb_topk.launch_sharded(
                q, slabs, valid, nids, k, mask_nodes=mask)) == 1
        assert _kernels_per_call(lambda: vdb_topk.launch_single(
            q, slabs[0, 1], valid[1], k)) == 1


def test_vdb_topk_merging_scans_keep_tickets_per_stream(dev):
    """The global K2 and a split K3 take their ticket counters from the
    stream they run on: the same launches queued on two streams at once
    give the plain version's lists, and a launch that would need more
    than ``MAX_TICKETS`` counters raises."""
    q, slabs, valid, nids = _fill_case(dev, 17, 4, 400, 512, 5)
    want2 = ref.vdb_topk_sharded_ref(q, slabs, valid, nids, 8,
                                     mask_nodes=False)
    q3, slabs3, valid3, _ = _scan_case(dev, 8, 2, 1025, 64, 6)
    db3, ok3 = slabs3[1, 1], valid3[1]          # split into 3 nodes
    want3 = ref.vdb_topk_ref(q3, db3, ok3, 8)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                got.append((vdb_topk.launch_sharded(
                    q, slabs, valid, nids, 8, mask_nodes=False),
                    vdb_topk.launch_single(q3, db3, ok3, 8)))
    torch.cuda.synchronize()
    for k2, k3 in got:
        _same_topk(k2, want2)
        _same_topk(k3, want3)
    with pytest.raises(ValueError, match="ticket counters"):
        vdb_topk._tickets(dev, vdb_topk.MAX_TICKETS + 1)


def test_vdb_topk_clustered_scans_refuse_too_wide_dims(dev):
    """K2 and K3 run on the clustered plan and raise where it cannot take
    a shape (no fallback)."""
    d = 1172                         # above the plan's 1168 at 16 queries
    q = torch.randn((16, d), device=dev)
    with pytest.raises(ValueError, match="too wide"):
        vdb_topk.launch_single(q, torch.randn((64, d), device=dev),
                               torch.ones((64,), dtype=torch.bool,
                                          device=dev), 4)
    with pytest.raises(ValueError, match="too wide"):
        vdb_topk.launch_sharded(q, torch.randn((1, 2, 64, d), device=dev),
                                torch.ones((2, 64), dtype=torch.bool,
                                           device=dev),
                                torch.zeros((16,), dtype=torch.int32,
                                            device=dev), 4)


# the 256 px VAE's resblock shapes at B = 1 and 8 ((128, 256) and
# (256, 128) read part of each block's chunk a second time)
VAE_SHAPES = [(b, hw, hw, c, 32) for b in (1, 8) for hw, c in (
    (128, 128), (64, 256), (32, 512), (64, 512), (128, 256), (256, 128))]


@pytest.mark.parametrize("b,h,w,c,groups", [
    (1, 1, 1, 4, 32), (2, 64, 64, 128, 32), (1, 32, 32, 48, 32),
    (8, 16, 16, 512, 32), (3, 9, 7, 64, 8)] + VAE_SHAPES)
def test_groupnorm_silu_matches_plain(dev, b, h, w, c, groups):
    g = torch.Generator().manual_seed(b * h + c)
    x = (torch.randn((b, h, w, c), generator=g) * 3 + 2).to(dev)
    scale = (torch.randn((c,), generator=g) * 0.3 + 1).to(dev)
    bias = (torch.randn((c,), generator=g) * 0.3).to(dev)
    got = groupnorm_silu.launch(x, scale, bias, groups=groups)
    torch.testing.assert_close(
        got, ref.groupnorm_silu_ref(x, scale, bias, groups=groups), **TOL)
    # the same bits on every run, and for an image alone or in a batch
    assert torch.equal(got, groupnorm_silu.launch(x, scale, bias,
                                                  groups=groups))
    assert torch.equal(got[-1:], groupnorm_silu.launch(
        x[-1:].contiguous(), scale, bias, groups=groups))


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 1, 1, 1, 32), (2, 65, 65, 3, 64), (1, 100, 300, 2, 128),
    (8, 256, 256, 12, 64), (3, 97, 161, 2, 32), (2, 1, 256, 12, 64),
    (2, 1, 256, 12, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_plain(dev, b, sq, sk, h, d, causal):
    g = torch.Generator().manual_seed(sq * 7 + d)
    q, k, v = (torch.randn((b, n, h, d), generator=g).to(dev)
               for n in (sq, sk, sk))
    torch.testing.assert_close(flash_attention.launch(q, k, v, causal=causal),
                               ref.flash_attention_ref(q, k, v,
                                                       causal=causal), **TOL)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_flash_attention_on_the_dits_strided_slices(dev, b):
    """q, k, v as every DiT block passes them: slices of one fused
    (B, T, 3, H, Dh) projection, at the batches the serving paths run
    (each takes its own block layout)."""
    g = torch.Generator().manual_seed(b)
    qkv = torch.randn((b, 256, 3, 12, 64), generator=g).to(dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    torch.testing.assert_close(flash_attention.launch(q, k, v),
                               ref.flash_attention_ref(q, k, v), **TOL)


@pytest.mark.parametrize("b,s,h,d", [(16, 1280, 24, 128), (4, 4352, 24, 128),
                                     (2, 1000, 4, 64), (1, 77, 2, 128)])
def test_flash_attention_bf16_matches_plain(dev, b, s, h, d):
    """K4 at bf16 as flux-dev's blocks hand it over: q, k contiguous and
    v a strided slice of the single block's fused projection (rows of
    3·H·D + 4·H·D), at gen_fast's and gen_1024's joint attention, a
    ragged length and head dim 64; against the plain version on the same
    bf16 inputs and the plain version in f32."""
    g = torch.Generator().manual_seed(s + d)
    u = torch.randn((b, s, 7 * h * d), generator=g).to(dev, torch.bfloat16)
    q = u[..., :h * d].reshape(b, s, h, d).contiguous()
    k = u[..., h * d:2 * h * d].reshape(b, s, h, d).contiguous()
    v = u[..., 2 * h * d:3 * h * d].reshape(b, s, h, d)
    got = flash_attention.launch(q, k, v)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               **BF16_TOL)
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q.float(), k.float(),
                                             v.float()), **BF16_TOL)


@pytest.mark.parametrize("sq,sk", [(64, 64), (100, 300), (1, 256)])
def test_flash_attention_bf16_causal_matches_plain(dev, sq, sk):
    g = torch.Generator().manual_seed(sq)
    q = torch.randn((2, sq, 3, 128), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((2, sk, 3, 128), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    torch.testing.assert_close(flash_attention.launch(q, k, v, causal=True),
                               ref.flash_attention_ref(q, k, v, causal=True),
                               **BF16_TOL)


def test_flash_attention_bf16_refuses_what_it_does_not_take(dev):
    kernels.reset_launches()
    x = torch.randn((1, 16, 2, 128), device=dev, dtype=torch.bfloat16)
    for d in (32, 96):
        with pytest.raises(ValueError, match="head dim"):
            flash_attention.launch(x[..., :d], x[..., :d], x[..., :d])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.launch(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="like q"):
        flash_attention.launch(x, x.float(), x)
    wide = torch.randn((1, 16, 2 * 128 + 4), device=dev,
                       dtype=torch.bfloat16)
    odd = wide[..., 4:].reshape(1, 16, 2, 128)   # rows not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.launch(x, x, odd)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch(x.cpu(), x.cpu(), x.cpu())
    assert kernels.LAUNCHES["flash_attention_bf16"] == 0
    flash_attention.launch(x, x, x)
    assert kernels.LAUNCHES["flash_attention_bf16"] == 1
    assert kernels.LAUNCHES["flash_attention"] == 0
    assert kernels.LAUNCHES_BY_SHAPE["flash_attention_bf16"] == {
        (1, 16, 16, 2, 128, 0): 1}


def _kernels_per_call(fn) -> int:
    """Kernels one call of ``fn`` puts on the card: the call captured into
    a CUDA graph, whose nodes ``cuGraphGetNodes`` counts."""
    import ctypes
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):     # set-up (attributes, a stream's
        fn()                          # ticket counters) outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    n = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                   ctypes.byref(n)) == 0
    return n.value


def test_groupnorm_silu_is_one_launch(dev):
    """Statistics, cluster merge and output in one kernel: one call,
    captured into a CUDA graph, is one graph node."""
    for shape in ((1, 32, 32, 512), (1, 256, 256, 128), (2, 9, 7, 48)):
        x = torch.randn(shape, device=dev)
        sc = torch.ones((shape[-1],), device=dev)
        assert _kernels_per_call(lambda: groupnorm_silu.launch(x, sc, sc)) \
            == 1


@pytest.mark.parametrize("cap", [1, 63, 400, 4096])
@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("qn", [1, 2, 3, 8, 17])
def test_vdb_topk_pernode_clustered_matches_plain(dev, cap, k, qn):
    """The clustered K1 scan at capacities of one tile, a ragged tile,
    the serving fleet's 400 and a loop over tiles per block; exact ties
    that straddle block boundaries, an empty node, masked rows."""
    if k > cap:
        pytest.skip("k exceeds the candidates per node")
    q, slabs, valid, _ = _scan_case(dev, qn, 4, cap, 512 if cap <= 400
                                    else 128, qn * 31 + cap + k)
    got = vdb_topk.launch_pernode(q, slabs, valid, k)
    _same_topk(got, ref.vdb_topk_pernode_ref(q, slabs, valid, k))
    # the same bits on a second run
    again = vdb_topk.launch_pernode(q, slabs, valid, k)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_vdb_topk_pernode_is_one_launch(dev):
    """Scan and merge in one kernel, with no scratch allocation: one call,
    captured into a CUDA graph, is one graph node."""
    for qn, cap, d, k in ((8, 400, 512, 8), (1, 400, 512, 5),
                          (17, 130, 64, 32), (3, 4096, 128, 8)):
        q, slabs, valid, _ = _scan_case(dev, qn, 4, cap, d, cap)
        assert _kernels_per_call(
            lambda: vdb_topk.launch_pernode(q, slabs, valid, k)) == 1


@pytest.mark.parametrize("b,t,d", [(1, 1, 4), (3, 77, 100), (8, 256, 768),
                                   (2, 16, 1536)])
def test_adaln_matches_plain(dev, b, t, d):
    g = torch.Generator().manual_seed(t + d)
    x = (torch.randn((b, t, d), generator=g) * 3 + 1).to(dev)
    ada = torch.randn((b, 2 * d), generator=g).to(dev)
    torch.testing.assert_close(adaln.launch(x, ada[:, :d], ada[:, d:]),
                               ref.adaln_modulate_ref(x, ada[:, :d],
                                                      ada[:, d:]), **TOL)


@pytest.mark.parametrize("b,d", [(1, 768), (2, 768), (4, 768), (8, 768),
                                 (2, 1152)])
def test_adaln_on_the_dits_chunk_views(dev, b, d):
    """shift and scale as every DiT block passes them (chunks of the
    (B, 6·D) adaLN projection, row stride 6·D) at the serving batches and
    at DiT-XL's width; a row gives the same bits alone and in the
    batch."""
    g = torch.Generator().manual_seed(b * d)
    x = (torch.randn((b, 256, d), generator=g) * 2 + 0.5).to(dev)
    ada = torch.randn((b, 6 * d), generator=g).to(dev)
    sh, sc = ada[:, 3 * d:4 * d], ada[:, 4 * d:5 * d]
    got = adaln.launch(x, sh, sc)
    torch.testing.assert_close(got, ref.adaln_modulate_ref(x, sh, sc), **TOL)
    alone = adaln.launch(x[-1:].contiguous(), sh[-1:], sc[-1:])
    assert torch.equal(alone, got[-1:])
    assert torch.equal(adaln.launch(x[:, 7:8].contiguous(), sh, sc),
                       got[:, 7:8])


def test_adaln_refuses_what_it_cannot_take(dev):
    x = torch.randn((1, 4, 770), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        adaln.launch(x, x[:, 0], x[:, 1])
    x = torch.randn((1, 4, adaln.MAX_DIM + 4), device=dev)
    with pytest.raises(ValueError, match="at most"):
        adaln.launch(x, x[:, 0], x[:, 1])
    y = torch.randn((2, 8, 64), device=dev)
    ada = torch.randn((2, 130), device=dev)
    with pytest.raises(ValueError, match="aligned"):
        adaln.launch(y, ada[:, 1:65], ada[:, 65:129])


def test_wrappers_count_launches_and_refuse_bad_input(dev):
    kernels.reset_launches()
    x = torch.randn((2, 8, 1, 64), device=dev)
    ops.flash_attention(x, x, x)
    ops.adaln_modulate(x[:, :, 0], x[:, 0, 0], x[:, 1, 0])
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert kernels.LAUNCHES["adaln_modulate"] == 1
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(x[..., :48], x[..., :48], x[..., :48])
    with pytest.raises(TypeError):
        ops.adaln_modulate(x[:, :, 0].double(), x[:, 0, 0], x[:, 1, 0])
    q = torch.randn((2, 16), device=dev)
    slabs = torch.randn((2, 1, 8, 16), device=dev)
    valid = torch.ones((1, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="k must be"):
        ops.vdb_topk_pernode(q, slabs, valid, 33)
    assert kernels.LAUNCHES["vdb_topk_pernode"] == 0
    db = torch.randn((64, 16), device=dev)
    ok = torch.ones((64,), dtype=torch.bool, device=dev)
    ops.vdb_topk(q, db, ok, 4)
    with pytest.raises(ValueError, match="k must be"):
        ops.vdb_topk(q, db, ok, 33)
    with pytest.raises(ValueError, match="exceeds"):
        ops.vdb_topk(q, db[:3], ok[:3], 4)
    assert kernels.LAUNCHES["vdb_topk"] == 1
    fm = torch.randn((1, 4, 4, 64), device=dev)
    ops.groupnorm_silu(fm, fm[0, 0, 0], fm[0, 0, 1])
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.groupnorm_silu(fm[..., :6].contiguous(), fm[0, 0, 0, :6],
                           fm[0, 0, 1, :6])
    with pytest.raises(ValueError, match="contiguous"):
        ops.groupnorm_silu(fm.transpose(1, 2), fm[0, 0, 0], fm[0, 0, 1])
    assert kernels.LAUNCHES["groupnorm_silu"] == 1
    assert kernels.LAUNCHES_BY_SHAPE["groupnorm_silu"] == {(1, 4, 4, 64): 1}
    assert kernels.LAUNCHES_BY_SHAPE["flash_attention"] == {
        (2, 8, 8, 1, 64, 0): 1}


# ---------------------------------------------------------------------------
# the port's precision, and the front door's threads
# ---------------------------------------------------------------------------

# a VAE pass on the card against the CPU, relative to the output's scale
# (chip_smoke.py's VAE_REL_TOL)
VAE_REL_TOL = 1e-4


def _small_models(seed: int = 0):
    from repro_torch.models.diffusion.dit import (DiT, DiTConfig,
                                                  perturb_zero_init_)
    from repro_torch.models.diffusion.vae import VAE, VAEConfig
    gen = torch.Generator().manual_seed(seed)
    dit = DiT(DiTConfig(img_res=8, in_ch=4, patch=2, n_layers=2,
                        d_model=128, n_heads=2, ctx_dim=512),
              generator=gen)
    perturb_zero_init_(dit, gen)
    vae = VAE(VAEConfig(in_ch=3, base_ch=32, ch_mult=(1, 2), z_ch=4,
                        n_res=1), generator=gen)
    return dit.eval(), vae.eval()


def _backend(dev, seed: int = 0):
    from repro_torch.core.embeddings import ProxyClipEmbedder
    from repro_torch.data.synthetic import render_caption
    from repro_torch.runtime.serving import DiffusionBackend
    dit, vae = _small_models(seed)
    emb = ProxyClipEmbedder(render_caption)
    return DiffusionBackend(dit, vae, lambda p: emb.embed_text([p])[0],
                            device=dev)


def test_backend_under_default_flags_holds_the_vae_to_the_cpu(dev):
    """PyTorch's defaults run cuDNN convolutions in TF32; a backend built
    on the card under them still encodes and decodes in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False      # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    backend = _backend(dev)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    _, cpu_vae = _small_models()
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    z = torch.randn((2, 8, 8, 4), generator=gen)

    def rel_errs():
        with torch.no_grad():
            return [float((got - want).abs().max() / want.abs().max())
                    for got, want in (
                        (backend.vae.encode(x.to(dev))[0].cpu(),
                         cpu_vae.encode(x)[0]),
                        (backend.vae.decode(z.to(dev)).cpu(),
                         cpu_vae.decode(z)))]
    errs = rel_errs()
    print(f"VAE card vs CPU, as the backend leaves the flags: encode "
          f"{errs[0]:.2e}, decode {errs[1]:.2e} of scale")
    assert max(errs) <= VAE_REL_TOL, errs
    # the check has teeth: with cuDNN's TF32 on, the same comparison
    # misses by more than the tolerance
    try:
        torch.backends.cudnn.allow_tf32 = True
        tf32 = rel_errs()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"VAE card vs CPU, cuDNN TF32 on: encode {tf32[0]:.2e}, decode "
          f"{tf32[1]:.2e} of scale")
    assert max(tf32) > VAE_REL_TOL, tf32


def _fleet(backend, dev):
    from repro_torch.core.policy import GenerationPolicy
    from repro_torch.launch.serve import build_system
    system, _, _, _ = build_system(
        n_nodes=2, corpus_n=60, capacity_per_node=80, seed=0,
        policy=GenerationPolicy(steps_full=4, steps_ref=2), backend=backend,
        device=dev)
    return system


def test_gateway_serves_from_its_worker_thread(dev):
    """Every kernel of a group launches from the dispatcher's thread: the
    images equal a main-thread ``serve_group`` of the same groups."""
    from repro_torch.core.trace import RequestTrace
    from repro_torch.frontdoor import Gateway
    from repro_torch.runtime.serving import Request, ServingEngine
    backend = _backend(dev)
    reqs = list(RequestTrace(seed=1).generate(12))
    gw = Gateway(ServingEngine(_fleet(backend, dev), max_batch=4),
                 fair=False)
    assert isinstance(gw.dispatcher._device_scope(), torch.cuda.device)
    handles = [gw.submit(r.prompt, tenant=f"t{i % 2}", seed=i,
                         quality_tier=r.quality_tier)
               for i, r in enumerate(reqs)]
    kernels.reset_launches()
    gw.start()
    try:
        for h in handles:
            h.wait(timeout=300)
    finally:
        gw.close(timeout=300)
    assert not gw.dispatcher.running
    assert kernels.LAUNCHES["vdb_topk_pernode"] > 0
    assert kernels.LAUNCHES["flash_attention"] > 0
    main = ServingEngine(_fleet(backend, dev), max_batch=4)
    done = []
    for i in range(0, len(reqs), 4):
        done += main.serve_group([
            Request(r.prompt, i + j, quality_tier=r.quality_tier)
            for j, r in enumerate(reqs[i:i + 4])])
    assert any(c.result.steps > 0 for c in done)
    for h, c in zip(handles, done):
        assert h.meta["route"] == (c.result.fast_path
                                   or c.result.route.value)
        assert h.meta["node"] == c.result.node
        img, want = h.image(), np.asarray(c.result.image)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(img, want, rtol=0, atol=1e-5 * scale)


def test_libraries_and_tickets_are_made_once_across_threads(dev):
    from repro_torch.kernels import _build
    mods = {"vdb_topk": vdb_topk, "flash_attention": flash_attention,
            "groupnorm_silu": groupnorm_silu, "adaln": adaln}
    _build.build_all()
    for name in mods:
        _build._LIBS.pop(name, None)
    stream = torch.cuda.Stream(device=dev)
    n = 16
    barrier = threading.Barrier(n)
    libs, tickets, errors = [], [], []

    def work():
        try:
            barrier.wait(timeout=60)
            libs.append({name: id(m._lib()) for name, m in mods.items()})
            with torch.cuda.stream(stream):
                tickets.append(vdb_topk._tickets(dev, 8).data_ptr())
        except BaseException as exc:          # reported below
            errors.append(exc)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(libs) == len(tickets) == n
    assert all(d == libs[0] for d in libs)
    assert len(set(tickets)) == 1
    assert sum(1 for key in vdb_topk._TICKETS
               if key[1] == stream.cuda_stream) == 1
    assert vdb_topk._lib().vdb_topk_single_launch.argtypes is not None
    # the reloaded libraries launch
    q, slabs, valid, nids = _scan_case(dev, 4, 2, 64, 16, 3)
    _same_topk(vdb_topk.launch_sharded(q, slabs, valid, nids, 4,
                                       mask_nodes=False),
               ref.vdb_topk_sharded_ref(q, slabs, valid, nids, 4,
                                        mask_nodes=False))


# ---------------------------------------------------------------------------
# kernels on any card of the process, and the node mesh
# ---------------------------------------------------------------------------


def _six_kernels(d):
    """(name, kernel call, plain call, exact slot ids) of K1-K6 (K4 at f32
    and at bf16) on inputs on device ``d``, at shapes whose launches take
    more than 48 KB of shared memory (a kernel attribute each launcher
    sets per device)."""
    q, slabs, valid, nids = _scan_case(d, 8, 4, 400, 512, 11)
    g = torch.Generator().manual_seed(12)
    x = torch.randn((2, 256, 12, 64), generator=g).to(d)
    xb = torch.randn((2, 256, 4, 128), generator=g).to(d, torch.bfloat16)
    h = torch.randn((1, 256, 768), generator=g).to(d)
    ada = torch.randn((1, 1536), generator=g).to(d)
    fm = torch.randn((2, 64, 64, 128), generator=g).to(d)
    sc, bi = (torch.randn((128,), generator=g).to(d) for _ in range(2))
    return [
        ("vdb_topk_pernode", lambda: ops.vdb_topk_pernode(q, slabs, valid, 8),
         lambda: ref.vdb_topk_pernode_ref(q, slabs, valid, 8), True),
        ("vdb_topk_sharded", lambda: ops.vdb_topk_sharded(
            q, slabs, valid, nids, 8),
         lambda: ref.vdb_topk_sharded_ref(q, slabs, valid, nids, 8), True),
        ("vdb_topk_sharded(global)", lambda: ops.vdb_topk_sharded(
            q, slabs, valid, nids, 8, mask_nodes=False),
         lambda: ref.vdb_topk_sharded_ref(q, slabs, valid, nids, 8,
                                          mask_nodes=False), True),
        ("vdb_topk", lambda: ops.vdb_topk(q, slabs[0].reshape(-1, 512),
                                          valid.reshape(-1), 8),
         lambda: ref.vdb_topk_ref(q, slabs[0].reshape(-1, 512),
                                  valid.reshape(-1), 8), True),
        ("flash_attention", lambda: ops.flash_attention(x, x, x),
         lambda: ref.flash_attention_ref(x, x, x), False),
        ("flash_attention_bf16", lambda: ops.flash_attention(xb, xb, xb),
         lambda: ref.flash_attention_ref(xb, xb, xb), False),
        ("adaln_modulate", lambda: ops.adaln_modulate(
            h, ada[:, :768], ada[:, 768:]),
         lambda: ref.adaln_modulate_ref(h, ada[:, :768], ada[:, 768:]),
         False),
        ("groupnorm_silu", lambda: ops.groupnorm_silu(fm, sc, bi),
         lambda: ref.groupnorm_silu_ref(fm, sc, bi), False),
    ]


def test_kernels_launch_on_a_second_card(dev):
    """Every kernel, launched first on card 0 and then on card 1 tensors
    with the current device left at card 0, equals its plain version on
    card 1, and the current device is still card 0 after each call."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    torch.cuda.set_device(0)
    for _, kernel, _, _ in _six_kernels(dev):
        kernel()
    torch.cuda.synchronize(0)
    other = torch.device("cuda", 1)
    for name, kernel, plain, exact in _six_kernels(other):
        got, want = kernel(), plain()
        assert torch.cuda.current_device() == 0, name
        if exact:
            _same_topk(got, want)
            assert got[0].device == other
        else:
            assert got.device == other
            torch.testing.assert_close(
                got, want, **(BF16_TOL if got.dtype == torch.bfloat16
                               else TOL))
    torch.cuda.synchronize(1)


def test_kernels_refuse_inputs_on_two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    q, slabs, valid, _ = _scan_case(dev, 2, 2, 16, 16, 1)
    with pytest.raises(ValueError, match="one device"):
        ops.vdb_topk_pernode(q.to("cuda:1"), slabs, valid, 4)
    x = torch.randn((1, 8, 1, 64), device=dev)
    with pytest.raises(ValueError, match="one device"):
        ops.flash_attention(x, x.to("cuda:1"), x)
    with pytest.raises(ValueError, match="one device"):
        ops.adaln_modulate(x[:, :, 0], x[:, 0, 0].to("cuda:1"), x[:, 0, 0])


def _mesh_devices(kind: str, n: int):
    if kind == "one card":
        return [torch.device("cuda", 0)] * n
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("kind", ["one card", "a card per shard"])
@pytest.mark.parametrize("mesh", [2, 3])
def test_mesh_scans_on_the_card_equal_one_device(dev, kind, mesh):
    """K1 and K2 (both modes) over 4 nodes split into 2 or 3 shards (pad
    nodes at 3): every shard's lists equal the plain version's on
    integer-valued inputs, and the merged lists equal one device's K1/K2
    over the unsplit slab, slots and scores."""
    from repro_torch.runtime import partition
    q, slabs, valid, nids = _scan_case(dev, 8, 4, 400, 512, 21)
    padded = partition.padded_nodes(4, mesh)
    n = padded // mesh
    full_s = torch.zeros((2, padded, 400, 512), device=dev)
    full_s[:, :4] = slabs
    full_v = torch.zeros((padded, 400), dtype=torch.bool, device=dev)
    full_v[:4] = valid
    devs = _mesh_devices(kind, mesh)
    shards = [(full_s[:, s * n:(s + 1) * n].contiguous().to(devs[s]),
               full_v[s * n:(s + 1) * n].contiguous().to(devs[s]))
              for s in range(mesh)]
    nid = nids.cpu().numpy()
    got = ops.vdb_topk_pernode_mesh(q, shards, 8)
    want = ops.vdb_topk_pernode_mesh(q, shards, 8, use_pallas=False)
    assert np.array_equal(got[1], want[1])
    one = vdb_topk.launch_pernode(q, slabs, valid, 8)
    assert np.array_equal(got[1][:, :4], one[1].cpu().numpy())
    assert np.array_equal(got[0][:, :4], one[0].cpu().numpy())
    for mask in (True, False):
        k_local = min(8, n * 400)
        got = ops.vdb_topk_sharded_mesh(q, shards, nid, k_local,
                                        mask_nodes=mask)
        want = ops.vdb_topk_sharded_mesh(q, shards, nid, k_local,
                                         mask_nodes=mask, use_pallas=False)
        assert np.array_equal(got[1], want[1])
        real = np.isfinite(want[0])
        assert (got[0][~real] <= -1e29).all()
        np.testing.assert_allclose(got[0][real], want[0][real], **TOL)
        merged = ops.merge_shard_topk(*got, 8)
        one = vdb_topk.launch_sharded(q, slabs, valid, nids, 8,
                                      mask_nodes=mask)
        assert np.array_equal(merged[1], one[1].cpu().numpy())
        assert np.array_equal(merged[0], one[0].cpu().numpy())
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("kind", ["one card", "a card per shard"])
def test_cluster_index_mesh_on_the_card_equals_the_cpu(dev, kind):
    """A 5-node fleet over 3 shards on the card: the three searches equal
    a CPU index's of mesh 1 over the same dbs, through rows added and
    evicted on every shard."""
    from repro_torch.core.cluster_index import ClusterIndex
    from repro_torch.core.vdb import VectorDB
    rng = np.random.default_rng(5)

    def unit(n):
        v = rng.standard_normal((n, 64)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    dbs = [VectorDB(64, 40, device=dev) for _ in range(5)]
    for i, db in enumerate(dbs[:4]):
        db.add(unit(10 + 7 * i), unit(10 + 7 * i), np.arange(10 + 7 * i),
               0.0)
    card = ClusterIndex.from_dbs(dbs, mesh_nodes=3,
                                 mesh_devices=_mesh_devices(kind, 3))
    cpu = ClusterIndex.from_dbs(dbs, device="cpu")
    for i, db in enumerate(dbs):
        db.add(unit(3), unit(3), np.arange(3) + 100, 1.0)
        db.evict_slots(np.array([i]))
    assert card.stats["slab_uploads"] == 1
    Q = unit(6)
    nids = rng.integers(0, 5, 6)
    pairs = [(card.search_cluster(Q, 9), cpu.search_cluster(Q, 9)),
             (card.search_batch(Q, nids, 8), cpu.search_batch(Q, nids, 8))]
    pairs += list(zip(card.search_cluster_nodes(Q, 8),
                      cpu.search_cluster_nodes(Q, 8)))
    for got, want in pairs:
        for (g_s, g_l), (w_s, w_l) in zip(got, want):
            assert np.array_equal(g_l, w_l)
            np.testing.assert_allclose(g_s, w_s, **TOL)
    for a, b in zip(card.device_state(), card.rebuild_reference()):
        assert np.array_equal(a, b)
