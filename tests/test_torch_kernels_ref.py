"""Plain versions of the port's kernels (``repro_torch.kernels.ref``)
against the JAX package's oracles (``repro.kernels.ref``), plus the
device dispatch of ``repro_torch.kernels.ops`` on the CPU.

Tolerance: 2e-5 for f32 (as ``tests/test_kernels.py``); slot ids and
every ``-inf`` position must be equal."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import adaln, flash_attention, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vdb_topk

TOL = dict(rtol=2e-5, atol=2e-5)


def _slabs_case(seed: int, *, ties: bool):
    """(2 planes, 3 nodes, 40 rows, dim 16): node 1 all invalid, node 2
    with only 2 valid rows (fewer than k).  ``ties`` makes integer-valued
    vectors with repeated rows, so equal scores are exact in both
    frameworks."""
    rng = np.random.default_rng(seed)
    if ties:
        slabs = rng.integers(-1, 2, size=(2, 3, 40, 16)).astype(np.float32)
        slabs[:, 0, 20:30] = slabs[:, 0, 5:15]        # repeated rows
        q = rng.integers(-1, 2, size=(4, 16)).astype(np.float32)
    else:
        slabs = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
        q = rng.normal(size=(4, 16)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    valid = rng.random((3, 40)) > 0.3
    valid[1] = False
    valid[2] = False
    valid[2, [3, 17]] = True
    return q, slabs, valid


def _assert_topk_equal(got, want):
    s_t, i_t = (np.asarray(x) for x in got)
    s_j, i_j = (np.asarray(x) for x in want)
    assert s_t.shape == s_j.shape
    np.testing.assert_array_equal(np.isneginf(s_t), np.isneginf(s_j))
    np.testing.assert_allclose(s_t, s_j, **TOL)
    np.testing.assert_array_equal(i_t, i_j)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_pernode_ref_matches_jax(ties, k):
    q, slabs, valid = _slabs_case(0, ties=ties)
    got = tref.vdb_topk_pernode_ref(torch.from_numpy(q),
                                    torch.from_numpy(slabs),
                                    torch.from_numpy(valid), k)
    want = jref.vdb_topk_pernode_ref(jnp.asarray(q), jnp.asarray(slabs),
                                     jnp.asarray(valid), k)
    _assert_topk_equal(got, want)
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("mask_nodes", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [3, 8])
def test_sharded_ref_matches_jax(mask_nodes, ties, k):
    q, slabs, valid = _slabs_case(1, ties=ties)
    node_ids = np.array([0, 1, 2, 0], np.int32)   # node 1 holds nothing
    got = tref.vdb_topk_sharded_ref(
        torch.from_numpy(q), torch.from_numpy(slabs),
        torch.from_numpy(valid), torch.from_numpy(node_ids), k,
        mask_nodes=mask_nodes)
    want = jref.vdb_topk_sharded_ref(
        jnp.asarray(q), jnp.asarray(slabs), jnp.asarray(valid),
        jnp.asarray(node_ids), k, mask_nodes=mask_nodes)
    _assert_topk_equal(got, want)


# node ids of the fill-rule cases, over _slabs_case's 3 nodes (node 1 all
# invalid, node 2 with 2 valid rows)
_FILL_CASES = {
    "short node": (np.array([2, 2, 0, 2], np.int32), 8),
    "empty node": (np.array([1, 0, 1, 1], np.int32), 5),
    "out of range": (np.array([3, -1, 0, 7], np.int32), 6),
    "k32 Q17": (np.arange(17, dtype=np.int32) % 5 - 1, 32),
}


def _fill_rule(valid, nid: int, k: int):
    """The masked fill of a node-masked list, from its definition: the
    node's valid rows come first (by score); the rest of the list is the
    other slots of the plane, the node's invalid rows included, in
    ascending global slot order."""
    n_nodes, cap = valid.shape
    own = np.zeros_like(valid)
    if 0 <= nid < n_nodes:
        own[nid] = valid[nid]
    n_real = int(own.sum())
    return n_real, np.flatnonzero(~own.reshape(-1))[:max(k - n_real, 0)]


@pytest.mark.parametrize("case", sorted(_FILL_CASES))
@pytest.mark.parametrize("mask_nodes", [True, False])
def test_sharded_ref_fill_rule_matches_jax(case, mask_nodes):
    """Lists that run out of real candidates (a node with fewer than k
    valid rows, an empty node, a node id outside [0, N), k = 32 at Q = 17)
    on integer-valued inputs: ids equal JAX's, and the node-masked fill
    is the plane's other slots in ascending order."""
    q, slabs, valid = _slabs_case(5, ties=True)
    node_ids, k = _FILL_CASES[case]
    if len(node_ids) != len(q):
        q = np.random.default_rng(6).integers(
            -1, 2, size=(len(node_ids), q.shape[1])).astype(np.float32)
    got = tref.vdb_topk_sharded_ref(
        torch.from_numpy(q), torch.from_numpy(slabs),
        torch.from_numpy(valid), torch.from_numpy(node_ids), k,
        mask_nodes=mask_nodes)
    want = jref.vdb_topk_sharded_ref(
        jnp.asarray(q), jnp.asarray(slabs), jnp.asarray(valid),
        jnp.asarray(node_ids), k, mask_nodes=mask_nodes)
    _assert_topk_equal(got, want)
    if not mask_nodes:
        return
    s, i = (x.numpy() for x in got)
    for row, nid in enumerate(node_ids):
        n_real, fill = _fill_rule(valid, int(nid), k)
        assert np.isfinite(s[:, row, :n_real]).all()
        assert np.isneginf(s[:, row, n_real:]).all()
        for plane in range(s.shape[0]):
            np.testing.assert_array_equal(i[plane, row, n_real:], fill)


def test_single_slab_ref_matches_jax():
    q, slabs, valid = _slabs_case(2, ties=True)
    got = tref.vdb_topk_ref(torch.from_numpy(q), torch.from_numpy(slabs[0, 0]),
                            torch.from_numpy(valid[0]), 6)
    want = jref.vdb_topk_ref(jnp.asarray(q), jnp.asarray(slabs[0, 0]),
                             jnp.asarray(valid[0]), 6)
    _assert_topk_equal(got, want)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 8, 8, 1, 8),
    (1, 33, 47, 2, 8),      # lengths not a multiple of the 64-row tile
    (2, 70, 70, 2, 16),
    (1, 16, 40, 2, 32),     # kv longer than q
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ref_matches_jax(b, sq, sk, h, d, causal):
    rng = np.random.default_rng(b * 100 + sq)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32)
               for n in (sq, sk, sk))
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,t,d", [(2, 16, 32), (3, 70, 48), (1, 5, 768)])
def test_adaln_ref_matches_jax(b, t, d):
    rng = np.random.default_rng(t)
    x = (rng.normal(size=(b, t, d)) * 3 + 1).astype(np.float32)
    shift, scale = (rng.normal(size=(b, d)).astype(np.float32)
                    for _ in range(2))
    got = tref.adaln_modulate_ref(*map(torch.from_numpy, (x, shift, scale)))
    want = jref.adaln_modulate_ref(*map(jnp.asarray, (x, shift, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_take_the_plain_versions_on_cpu():
    q, slabs, valid = (torch.from_numpy(a) for a in _slabs_case(3, ties=False))
    nids = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    for got, want in (
            (ops.vdb_topk_pernode(q, slabs, valid, 4),
             tref.vdb_topk_pernode_ref(q, slabs, valid, 4)),
            (ops.vdb_topk_sharded(q, slabs, valid, nids, 4, mask_nodes=True),
             tref.vdb_topk_sharded_ref(q, slabs, valid, nids, 4))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ops.flash_attention(x[..., None, :4], x[..., None, 4:8],
                                           x[..., None, 8:12]),
                       tref.flash_attention_ref(x[..., None, :4],
                                                x[..., None, 4:8],
                                                x[..., None, 8:12]))
    assert torch.equal(ops.adaln_modulate(x, x[:, 0], x[:, 1]),
                       tref.adaln_modulate_ref(x, x[:, 0], x[:, 1]))


def test_ops_refuse_devices_without_a_kernel():
    x = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.adaln_modulate(x, x[:, 0], x[:, 1])


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the card a wrapper launches its kernel or raises — it never
    runs the plain version itself."""
    q, slabs, valid = (torch.from_numpy(a) for a in _slabs_case(4, ties=False))
    with pytest.raises(ValueError, match="CUDA"):
        vdb_topk.launch_pernode(q, slabs, valid, 4)
    with pytest.raises(ValueError, match="CUDA"):
        vdb_topk.launch_sharded(q, slabs, valid, torch.zeros(4, dtype=torch.int32), 4)
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch(x, x, x)
    y = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        adaln.launch(y, y[:, 0], y[:, 1])


def test_launch_counts_by_kernel_and_shape():
    """``count_launch`` (what a wrapper calls right after its launch) adds
    to the kernel's total and to its count at that shape; the reset
    clears both."""
    from repro_torch import kernels
    kernels.reset_launches()
    kernels.count_launch("flash_attention", (1, 256, 256, 12, 64, 0))
    kernels.count_launch("flash_attention", (1, 256, 256, 12, 64, 0))
    kernels.count_launch("groupnorm_silu", (8, 32, 32, 512))
    assert kernels.LAUNCHES["flash_attention"] == 2
    assert kernels.LAUNCHES_BY_SHAPE["flash_attention"] == {
        (1, 256, 256, 12, 64, 0): 2}
    assert sum(kernels.LAUNCHES.values()) == 3
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.LAUNCHES_BY_SHAPE.values())
