"""Cosine scans + streaming top-k on the card (CUDA C++).

Replaces the TPU kernels of ``repro/kernels/vdb_topk.py``:
``_vdb_sharded_kernel`` behind its two entry points,
``vdb_topk_pernode`` (K1, the score-routing scan, one launch per
micro-batch) and ``vdb_topk_sharded`` (K2, the masked retrieval scan of
centroid routing), and ``_vdb_kernel`` behind ``vdb_topk`` (K3, the
single-slab scan of a standalone ``VectorDB``, once per index).  Source:
``csrc/vdb_topk.cu``: K1's clustered kernel, and one two-pass template
for K2 and K3 (K3 is its per-node scan over one plane and one node);
plain versions:
:func:`repro_torch.kernels.ref.vdb_topk_pernode_ref`,
:func:`~repro_torch.kernels.ref.vdb_topk_sharded_ref` and
:func:`~repro_torch.kernels.ref.vdb_topk_ref`.

What bounds it on the card: the slab bytes, each row read once per
launch (memory): 6.6 MB for the serving fleet's 2 planes x 4 nodes x 400
slots x 512 dims, 2.0 us at 3.35 TB/s.  The TPU kernel streams the slab
through VMEM on one core in grid order.  On the GPU, K1 is one launch:
a thread-block cluster per (plane, node, tile of up to 16 queries)
whose blocks split the node's rows (:func:`pernode_plan`), stream them
through shared memory, keep each query's running top-k in a warp's
registers and merge the blocks' lists through distributed shared memory
— no scratch lists in device memory.  K2 and K3 cut the capacity axis
into 64-row chunks scanned by independent blocks, and a second launch
merges the chunk lists.  K3 at a standalone node's size (400 x 512 f32,
0.82 MB) has a bound of about 0.25 us, so it is latency bound.  See the
source for both designs and the order they keep.

Results equal the plain versions': the same slots in the same order
(score descending, then global slot ascending), scores within f32
rounding, and masked candidates as the ``-1e30`` sentinel where the
plain version has ``-inf``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

MAX_K = 32                     # the kernel's top-k limit
_P = ctypes.c_void_p
_I = ctypes.c_int
# the clustered K1 scan (csrc/vdb_topk.cu): queries a block, blocks a
# cluster, rows a tile, tiles in flight, a block's shared memory
QUERY_TILES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 8
MIN_BLOCK_ROWS = 32
TILE_ROWS = 32
MAX_STAGES = 4
SMEM_LIMIT = 232448


def _lib():
    lib = _build.library("vdb_topk")
    if lib.vdb_topk_launch.argtypes is None:
        lib.vdb_topk_launch.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        lib.vdb_topk_launch.restype = ctypes.c_int
        lib.vdb_topk_chunks.argtypes = [_I]
        lib.vdb_topk_chunks.restype = ctypes.c_int
        lib.vdb_topk_single_launch.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.vdb_topk_single_launch.restype = ctypes.c_int
        lib.vdb_topk_pernode_launch.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        lib.vdb_topk_pernode_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def pernode_plan(n_q: int, cap: int, dim: int) -> dict:
    """How the clustered K1 scan cuts its work: ``query_tile`` queries a
    block (the micro-batch rounded up to 1, 2, 4, 8 or 16; more queries
    take more tiles), ``cluster_blocks`` blocks a (plane, node), each of
    ``block_rows`` contiguous capacity rows (at least ``MIN_BLOCK_ROWS``
    where the capacity allows), read in tiles of 32 rows with ``stages``
    tiles in flight, in ``smem_bytes`` of shared memory.  Depends on the
    shapes only."""
    qt = next((t for t in QUERY_TILES if t >= n_q), QUERY_TILES[-1])
    cl = max(1, min(MAX_CLUSTER, -(-cap // MIN_BLOCK_ROWS)))
    rows = -(-cap // cl)
    fixed = 4 * (qt * dim + qt * TILE_ROWS + 2 * qt * MAX_K + 2 * 8 * 32)
    stage = 4 * TILE_ROWS * dim
    stages = min(MAX_STAGES, -(-rows // TILE_ROWS),
                 (SMEM_LIMIT - fixed) // stage)
    if stages < 1:
        raise ValueError(f"dim {dim} is too wide for the per-node scan")
    return dict(query_tile=qt, cluster_blocks=cl, block_rows=rows,
                stages=stages, smem_bytes=fixed + stages * stage)


def _check_inputs(queries, slabs, valid, k: int):
    for name, t in (("queries", queries), ("slabs", slabs), ("valid", valid)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.dtype != torch.float32 or slabs.dtype != torch.float32:
        raise TypeError("queries and slabs must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if queries.dim() != 2 or slabs.dim() != 4 or valid.dim() != 2:
        raise ValueError("expected queries (Q, D), slabs (P, N, cap, D), "
                         "valid (N, cap)")
    n_idx, n_nodes, cap, d = slabs.shape
    if queries.shape[1] != d or tuple(valid.shape) != (n_nodes, cap):
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"slabs {tuple(slabs.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if d % 4:
        raise ValueError(f"dim must be a multiple of 4, got {d}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def launch_pernode(queries, slabs, valid, k: int):
    """K1: (scores, global slot ids) of shape (P, N, Q, k), one launch."""
    _check_inputs(queries, slabs, valid, k)
    n_idx, n_nodes, cap, d = slabs.shape
    qn = queries.shape[0]
    if k > cap:
        raise ValueError(f"k={k} exceeds the candidates per list")
    if qn < 1 or queries.data_ptr() % 16 or slabs.data_ptr() % 16:
        raise ValueError("need at least one query and 16-byte aligned "
                         "queries and slabs")
    p = pernode_plan(qn, cap, d)
    dev = queries.device
    out_s = torch.empty((n_idx, n_nodes, qn, k), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_idx, n_nodes, qn, k), dtype=torch.int32,
                        device=dev)
    err = _lib().vdb_topk_pernode_launch(
        queries.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), n_idx, n_nodes, cap, d, qn, k,
        p["query_tile"], p["cluster_blocks"], p["block_rows"], p["stages"],
        _build.stream(queries))
    _build.check(err, "vdb_topk_pernode")
    kernels.count_launch("vdb_topk_pernode", (qn, *slabs.shape, k))
    return out_s, out_i


def launch_sharded(queries, slabs, valid, node_ids, k: int, *,
                   mask_nodes: bool = True):
    """K2: (scores, global slot ids) of shape (P, Q, k)."""
    _check_inputs(queries, slabs, valid, k)
    n_idx, n_nodes, cap, d = slabs.shape
    qn = queries.shape[0]
    if k > n_nodes * cap:
        raise ValueError(f"k={k} exceeds the candidates per list")
    lib = _lib()
    dev = queries.device
    chunks = lib.vdb_topk_chunks(cap)
    part_s = torch.empty((n_idx * n_nodes * chunks * qn * k,),
                         dtype=torch.float32, device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    out_s = torch.empty((n_idx, qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_idx, qn, k), dtype=torch.int32, device=dev)
    node_ids = node_ids.to(device=dev, dtype=torch.int32).contiguous()
    stream = _build.stream(queries)
    err = lib.vdb_topk_launch(
        queries.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
        node_ids.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), n_idx, n_nodes, cap, d, qn, k,
        0, int(mask_nodes), stream)
    _build.check(err, "vdb_topk")
    kernels.count_launch("vdb_topk_sharded",
                         (queries.shape[0], *slabs.shape, k))
    return out_s, out_i


def launch_single(queries, db, valid, k: int):
    """K3: queries (Q, D), db (N, D) float32, valid (N,) bool, all
    contiguous CUDA tensors -> (scores, row ids) of shape (Q, k), ordered
    by score descending, then row ascending; masked rows score -1e30."""
    if db.dim() != 2 or valid.dim() != 1:
        raise ValueError("expected db (N, D) and valid (N,)")
    _check_inputs(queries, db[None, None], valid[None], k)
    n, d = db.shape
    qn = queries.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the db's {n} rows")
    lib = _lib()
    dev = queries.device
    chunks = lib.vdb_topk_chunks(n)
    part_s = torch.empty((chunks * qn * k,), dtype=torch.float32, device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    stream = _build.stream(queries)
    err = lib.vdb_topk_single_launch(
        queries.data_ptr(), db.data_ptr(), valid.data_ptr(),
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), n, d, qn, k, stream)
    _build.check(err, "vdb_topk")
    kernels.count_launch("vdb_topk", (qn, n, d, k))
    return out_s, out_i
