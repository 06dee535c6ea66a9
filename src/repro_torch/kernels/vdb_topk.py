"""Cosine scans + streaming top-k on the card (CUDA C++).

Replaces the TPU kernels of ``repro/kernels/vdb_topk.py``:
``_vdb_sharded_kernel`` behind its two entry points,
``vdb_topk_pernode`` (K1, the score-routing scan, one launch per
micro-batch) and ``vdb_topk_sharded`` (K2, the node-masked retrieval
scan of centroid routing, and the global scan of ``search_cluster``),
and ``_vdb_kernel`` behind ``vdb_topk`` (K3, the single-slab scan of a
standalone ``VectorDB``, once per index).  Source: ``csrc/vdb_topk.cu``,
one clustered scan behind three entry points; plain versions:
:func:`repro_torch.kernels.ref.vdb_topk_pernode_ref`,
:func:`~repro_torch.kernels.ref.vdb_topk_sharded_ref` and
:func:`~repro_torch.kernels.ref.vdb_topk_ref`.

What bounds it on the card: the slab bytes, each row read once per
launch (memory): 6.6 MB for the serving fleet's 2 planes x 4 nodes x 400
slots x 512 dims, 2.0 us at 3.35 TB/s; K3 at a standalone node's size
(400 x 512 f32, 0.82 MB) about 0.25 us.  The TPU kernel streams the slab
through VMEM on one core in grid order.  On the GPU every call is one
launch: a thread-block cluster per (plane, node, tile of up to 16
queries) whose blocks split the node's rows (:func:`pernode_plan`),
stream them through shared memory, keep each query's running top-k in a
warp's registers and merge the blocks' lists through distributed shared
memory.  K3 is that scan over one plane and one node.  K2 node-masked
keeps, in each cluster, only the queries of its node, skips a node no
query names, and writes the masked fill (other nodes' slots) without
reading their rows; K2 global merges the node lists of a plane in the
last node cluster to finish (an atomic ticket), through a (P, N, Q, k)
buffer.  At the serving shapes every call is latency bound.  See the
source for the design and the order it keeps.

Results equal the plain versions': the same slots in the same order
(score descending, then global slot ascending), scores within f32
rounding, and masked candidates as the ``-1e30`` sentinel where the
plain version has ``-inf``.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

MAX_K = 32                     # the kernel's top-k limit
_P = ctypes.c_void_p
_I = ctypes.c_int
# the clustered scan (csrc/vdb_topk.cu): queries a block, blocks a
# cluster, rows a tile, tiles in flight, a block's shared memory
QUERY_TILES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 8
MIN_BLOCK_ROWS = 32
TILE_ROWS = 32
MAX_STAGES = 4
SMEM_LIMIT = 232448
# K3: a db of more rows is split into nodes of at most this many, one
# cluster each, merged as the global scan merges nodes
SINGLE_NODE_ROWS = 512


def _declare(lib) -> None:
    lib.vdb_topk_pernode_launch.argtypes = [_P] * 5 + [_I] * 10 + [_P]
    lib.vdb_topk_pernode_launch.restype = ctypes.c_int
    lib.vdb_topk_sharded_launch.argtypes = [_P] * 9 + [_I] * 11 + [_P]
    lib.vdb_topk_sharded_launch.restype = ctypes.c_int
    lib.vdb_topk_single_launch.argtypes = [_P] * 8 + [_I] * 10 + [_P]
    lib.vdb_topk_single_launch.restype = ctypes.c_int


def _lib():
    return _build.library("vdb_topk", _declare)


# ticket counters a launch that merges node lists may use: P x query
# tiles x cluster blocks (P = 2 and clusters of 8: up to 32768 queries)
MAX_TICKETS = 1 << 15
_TICKETS: dict = {}
_TICKETS_LOCK = threading.Lock()


def _tickets(dev, n: int) -> torch.Tensor:
    """The ticket counters of a launch that merges node lists across
    clusters: ``MAX_TICKETS`` zeros for each (device, stream), allocated
    at a stream's first such launch and never replaced, so a CUDA graph
    that captured them keeps valid memory.  Every launch leaves the
    counters it used at zero, so a call makes no memset and a graph
    captures one kernel.  Launches on one stream run in order, so no two
    use a stream's counters at once; a graph replays with the counters of
    the stream it was captured on, so replay it on that stream or after
    it.  A stream's counters are made outside capture: call once on the
    stream before capturing on it.  The look-up and the allocation are
    one step under a lock, so threads that ask at once get one buffer."""
    if n > MAX_TICKETS:
        raise ValueError(f"{n} ticket counters exceed {MAX_TICKETS}: too "
                         "many queries for one launch")
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    with _TICKETS_LOCK:
        t = _TICKETS.get(key)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the merging scan's ticket counters for "
                                   "this stream do not exist yet: call it "
                                   "once on the stream before capturing")
            t = torch.zeros((MAX_TICKETS,), dtype=torch.int32, device=dev)
            _TICKETS[key] = t
    return t


@functools.lru_cache(maxsize=None)
def pernode_plan(n_q: int, cap: int, dim: int) -> dict:
    """How the clustered scan cuts its work: ``query_tile`` queries a
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
        raise ValueError(f"dim {dim} is too wide for the clustered scan")
    return dict(query_tile=qt, cluster_blocks=cl, block_rows=rows,
                stages=stages, smem_bytes=fixed + stages * stage)


@functools.lru_cache(maxsize=None)
def single_plan(n_q: int, n: int, dim: int) -> dict:
    """How K3 cuts a db of ``n`` rows: ``split`` nodes of ``segment`` rows
    (the last one short), each scanned by :func:`pernode_plan`'s cluster;
    one node, and no merge across clusters, up to ``SINGLE_NODE_ROWS``."""
    seg = -(-n // -(-n // SINGLE_NODE_ROWS))
    return dict(pernode_plan(n_q, seg, dim), split=-(-n // seg),
                segment=seg)


def _check_inputs(queries, slabs, valid, k: int):
    for name, t in (("queries", queries), ("slabs", slabs), ("valid", valid)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not queries.device == slabs.device == valid.device:
        raise ValueError("queries, slabs and valid must be on one device")
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


def _check_aligned(queries, slabs):
    if queries.shape[0] < 1 or queries.data_ptr() % 16 \
            or slabs.data_ptr() % 16:
        raise ValueError("need at least one query and 16-byte aligned "
                         "queries and slabs")


def _plan_args(p: dict):
    return (p["query_tile"], p["cluster_blocks"], p["block_rows"],
            p["stages"])


def _merge_buffers(dev, shape, n_tickets: int, merge: bool):
    """The node lists (scores and ids, ``shape``) and ticket counters of
    a launch that merges node lists across clusters; Nones when it merges
    none.  The caller holds them until the launch is queued (the allocator
    then reuses them only for later work on the same stream)."""
    if not merge:
        return None, None, None
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            _tickets(dev, n_tickets))


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def launch_pernode(queries, slabs, valid, k: int):
    """K1: (scores, global slot ids) of shape (P, N, Q, k), one launch."""
    _check_inputs(queries, slabs, valid, k)
    n_idx, n_nodes, cap, d = slabs.shape
    qn = queries.shape[0]
    if k > cap:
        raise ValueError(f"k={k} exceeds the candidates per list")
    _check_aligned(queries, slabs)
    p = pernode_plan(qn, cap, d)
    dev = queries.device
    out_s = torch.empty((n_idx, n_nodes, qn, k), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_idx, n_nodes, qn, k), dtype=torch.int32,
                        device=dev)
    err = _build.launch(
        queries, _lib().vdb_topk_pernode_launch, queries.data_ptr(),
        slabs.data_ptr(), valid.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), n_idx, n_nodes, cap, d, qn, k, *_plan_args(p),
        _build.stream(queries))
    _build.check(err, "vdb_topk_pernode")
    kernels.count_launch("vdb_topk_pernode", (qn, *slabs.shape, k))
    return out_s, out_i


def launch_sharded(queries, slabs, valid, node_ids, k: int, *,
                   mask_nodes: bool = True):
    """K2: (scores, global slot ids) of shape (P, Q, k), one launch.
    ``mask_nodes``: query q's list holds the candidates of node
    ``node_ids[q]`` (a node id outside [0, N) gets masked slots 0..k-1);
    else one list over every node."""
    _check_inputs(queries, slabs, valid, k)
    n_idx, n_nodes, cap, d = slabs.shape
    qn = queries.shape[0]
    if k > n_nodes * cap:
        raise ValueError(f"k={k} exceeds the candidates per list")
    if tuple(node_ids.shape) != (qn,):
        raise ValueError(f"node_ids must be ({qn},), got "
                         f"{tuple(node_ids.shape)}")
    _check_aligned(queries, slabs)
    p = pernode_plan(qn, cap, d)
    dev = queries.device
    out_s = torch.empty((n_idx, qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_idx, qn, k), dtype=torch.int32, device=dev)
    node_ids = node_ids.to(device=dev, dtype=torch.int32).contiguous()
    n_tickets = n_idx * -(-qn // p["query_tile"]) * p["cluster_blocks"]
    merge = _merge_buffers(dev, (n_idx, n_nodes, qn, k), n_tickets,
                           not mask_nodes)
    err = _build.launch(
        queries, _lib().vdb_topk_sharded_launch, queries.data_ptr(),
        slabs.data_ptr(), valid.data_ptr(), node_ids.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        *_ptrs(merge), n_idx, n_nodes, cap, d, qn, k, int(mask_nodes),
        *_plan_args(p), _build.stream(queries))
    _build.check(err, "vdb_topk_sharded")
    kernels.count_launch("vdb_topk_sharded",
                         (queries.shape[0], *slabs.shape, k))
    return out_s, out_i


def launch_single(queries, db, valid, k: int):
    """K3: queries (Q, D), db (N, D) float32, valid (N,) bool, all
    contiguous CUDA tensors -> (scores, row ids) of shape (Q, k), ordered
    by score descending, then row ascending; masked rows score -1e30.
    One launch of the clustered scan (:func:`single_plan`)."""
    if db.dim() != 2 or valid.dim() != 1:
        raise ValueError("expected db (N, D) and valid (N,)")
    _check_inputs(queries, db[None, None], valid[None], k)
    n, d = db.shape
    qn = queries.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the db's {n} rows")
    _check_aligned(queries, db)
    p = single_plan(qn, n, d)
    dev = queries.device
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    n_tickets = -(-qn // p["query_tile"]) * p["cluster_blocks"]
    merge = _merge_buffers(dev, (p["split"], qn, k), n_tickets,
                           p["split"] > 1)
    err = _build.launch(
        queries, _lib().vdb_topk_single_launch, queries.data_ptr(),
        db.data_ptr(), valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        *_ptrs(merge), n, d, qn, k,
        p["split"], p["segment"], *_plan_args(p), _build.stream(queries))
    _build.check(err, "vdb_topk")
    kernels.count_launch("vdb_topk", (qn, n, d, k))
    return out_s, out_i
