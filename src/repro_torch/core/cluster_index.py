"""Device-resident cross-node retrieval engine — the port of the JAX
package's ``repro/core/cluster_index.py``.

The cluster's whole cache state lives ON DEVICE as one stacked slab

    slabs: (2, nodes, capacity, dim)    # plane 0 = img index, 1 = txt
    valid: (nodes, capacity)            # shared dual-index validity

and is updated INCREMENTALLY: every ``VectorDB.add`` / ``evict_slots``
pushes only the touched rows.  Where the JAX version rebuilds the slab
through a donated functional scatter, the port writes the rows in place
with ``index_copy_`` on the device tensors — after the one build-time
upload there are no steady-state host→device slab copies
(``stats["slab_uploads"]`` counts full-slab uploads,
``stats["row_updates"]`` the incremental ones).

Retrieval is ONE fused scan per micro-batch regardless of node count
(``stats["fused_scans"]``): ``search_batch`` answers every query against
its scheduled node's slab (K2, ``vdb_topk_sharded`` with the query→node
mask), ``search_cluster`` gives one global candidate list per query (K2
unmasked), and ``search_cluster_nodes`` a top-k PER node per query (K1,
``vdb_topk_pernode`` — the scan score-aware scheduling issues once per
micro-batch and the Retrieve stage reuses); each is one launch of the
clustered scan in ``kernels/csrc/vdb_topk.cu``.  With ``use_pallas`` (the
port's default) the scans go through
:mod:`repro_torch.kernels.ops`, i.e. the CUDA kernels for a CUDA index
and the plain versions for a CPU one; ``use_pallas=False`` runs the
plain versions on any device.

``mesh_nodes > 1`` shards all of the above over a node mesh
(:mod:`repro_torch.launch.mesh`): the node axis pads up to a multiple of
the mesh with nodes that are never valid
(:mod:`repro_torch.runtime.partition`), and each shard's
``(2, n_shard, capacity, dim)`` slab and ``(n_shard, capacity)``
validity live on the shard's device.  A scan launches K1 or K2 on every
shard (:func:`repro_torch.kernels.ops.vdb_topk_pernode_mesh` /
``vdb_topk_sharded_mesh``), still one ``fused_scans`` tick; only the
per-shard best-k lists come back to the host (``stats
["allgather_bytes"]``), and the global modes merge them with the
one-device tie-break (``merge_shard_topk``), so every result equals the
unsharded index's bitwise.  Row updates go to the owning shard in place,
so the zero steady-state slab uploads hold on a mesh too.

Queries are scanned at their true batch size: the JAX version pads the
query block to a power of two so that XLA compiles a handful of shapes;
eager PyTorch has nothing to compile, so there are no padded rows to
score or to cut off.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.vdb import VectorDB, _union_topk
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_node_mesh
from repro_torch.runtime import partition
from repro_torch.utils import l2n


class ClusterIndex:
    """Device-resident dual-index cache state for a whole node fleet."""

    def __init__(self, dim: int, capacities: Sequence[int], *,
                 use_pallas: bool = True, mesh_nodes: int = 1,
                 device="cuda", mesh_devices: Optional[Sequence] = None):
        self.dim = dim
        self.capacities = [int(c) for c in capacities]
        self.n_nodes = len(self.capacities)
        self.capacity = max(self.capacities) if self.capacities else 0
        self.use_pallas = use_pallas
        self.mesh_nodes = int(mesh_nodes)
        # the mesh's devices: given, or as make_node_mesh places them
        # (which refuses a mesh of no shard); without a mesh the one
        # shard lives on ``device``
        self.mesh = (make_node_mesh(self.mesh_nodes, device,
                                    devices=mesh_devices)
                     if self.mesh_nodes != 1 or mesh_devices is not None
                     else None)
        devices = (self.mesh.devices if self.mesh is not None
                   else (torch.device(device),))
        self.device = devices[0]
        self.padded_nodes = partition.padded_nodes(self.n_nodes,
                                                   self.mesh_nodes)
        self.n_shard = self.padded_nodes // self.mesh_nodes
        self.dbs: List[Optional[VectorDB]] = [None] * self.n_nodes
        self.stats: Dict[str, int] = {
            "slab_uploads": 0, "row_updates": 0, "fused_scans": 0,
            "allgather_bytes": 0}
        # one (slabs, valid) pair per shard, shard s holding nodes
        # s * n_shard .. (s + 1) * n_shard - 1 (pad nodes stay invalid)
        self.shards: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros((2, self.n_shard, self.capacity, dim),
                         dtype=torch.float32, device=d),
             torch.zeros((self.n_shard, self.capacity), dtype=torch.bool,
                         device=d))
            for d in devices]

    def per_device_slab_bytes(self) -> int:
        """Bytes of cluster cache state on the fullest device: what the
        mesh shrinks (a card that holds several shards counts them
        all)."""
        return max(partition.device_bytes(
            t for pair in self.shards for t in pair).values())

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dbs(cls, dbs: Sequence[VectorDB], *,
                 use_pallas: Optional[bool] = None, mesh_nodes: int = 1,
                 device="cuda", mesh_devices: Optional[Sequence] = None,
                 ) -> "ClusterIndex":
        """Build the stacked device slabs from a fleet's current numpy
        state (ONE upload, whatever the shards) and register each db as a
        view: subsequent mutations flow through the incremental row
        updates."""
        if use_pallas is None:
            use_pallas = any(db.use_pallas for db in dbs)
        ci = cls(dbs[0].dim, [db.capacity for db in dbs],
                 use_pallas=use_pallas, mesh_nodes=mesh_nodes, device=device,
                 mesh_devices=mesh_devices)
        ci.dbs = list(dbs)
        img, val = ci.rebuild_reference()
        for s, (slabs, valid) in enumerate(ci.shards):
            lo = min(s * ci.n_shard, ci.n_nodes)
            hi = min(lo + ci.n_shard, ci.n_nodes)
            slabs[:, :hi - lo].copy_(torch.from_numpy(img[:, lo:hi]))
            valid[:hi - lo].copy_(torch.from_numpy(val[lo:hi]))
        ci.stats["slab_uploads"] += 1
        for ni, db in enumerate(dbs):
            db.register_cluster(ci, ni)
        return ci

    # -- incremental mutation (called by the VectorDB views) ----------------

    def _owner(self, node: int):
        """(slabs, valid, node within them) of the shard holding
        ``node``."""
        shard, local = partition.owner(node, self.n_shard)
        slabs, valid = self.shards[shard]
        return slabs, valid, local

    def update_rows(self, node: int, slots: np.ndarray,
                    img_rows: np.ndarray, txt_rows: np.ndarray) -> None:
        """A batch of rows was inserted into ``node`` at ``slots``:
        in-place ``index_copy_`` into both planes and the validity of the
        node's shard."""
        if np.size(slots) == 0:
            return
        slabs, valid, local = self._owner(node)
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=slabs.device)
        for plane, rows in ((0, img_rows), (1, txt_rows)):
            slabs[plane, local].index_copy_(
                0, idx, torch.as_tensor(np.asarray(rows, np.float32),
                                        device=slabs.device))
        valid[local].index_fill_(0, idx, True)
        self.stats["row_updates"] += 1

    def invalidate_rows(self, node: int, slots: np.ndarray) -> None:
        """Slots were evicted from ``node`` — only validity flips (the
        numpy slabs keep the stale vectors too)."""
        if np.size(slots) == 0:
            return
        _, valid, local = self._owner(node)
        valid[local].index_fill_(0, torch.as_tensor(
            np.asarray(slots, np.int64), device=valid.device), False)
        self.stats["row_updates"] += 1

    def refresh_node(self, node: int,
                     db: Optional[VectorDB] = None) -> None:
        """Escape hatch: re-upload one node's slab from its numpy state
        after out-of-band mutation.  Pass ``db`` to REBIND the view to a
        replacement object (e.g. a ``VectorDB.restore`` result)."""
        if db is not None:
            old = self.dbs[node]
            if old is not None:
                old.unregister_cluster(self)
            self.dbs[node] = db
            db.register_cluster(self, node)
        db = self.dbs[node]
        if db is None:
            return
        img, val = self.rebuild_reference()
        slabs, valid, local = self._owner(node)
        slabs[:, local].copy_(torch.from_numpy(img[:, node]))
        valid[local].copy_(torch.from_numpy(val[node]))
        self.stats["slab_uploads"] += 1

    # -- search -------------------------------------------------------------

    def _planes(self, index: str) -> Tuple[int, ...]:
        return {"img": (0,), "txt": (1,), "both": (0, 1)}[index]

    def _prep_queries(self, query_vecs: np.ndarray):
        """L2-normalised queries on the device; ``(None, 0)`` for none."""
        Q = np.atleast_2d(np.asarray(query_vecs, np.float32))
        if Q.shape[0] == 0:
            return None, 0
        return torch.from_numpy(l2n(Q)).to(self.device), Q.shape[0]

    def _scan(self, q: torch.Tensor, node_ids: Optional[np.ndarray], k: int,
              index: str, mask_nodes: bool, *, per_node: bool = False):
        """The one scan (every scan mode dispatches here): returns
        (scores, global idx) numpy arrays of shape (planes, Q, k) — or
        (planes, nodes, Q, k) with ``per_node=True``, where the top-k is
        kept per node and ``node_ids``/``mask_nodes`` are ignored.  On a
        mesh, one launch per shard."""
        planes = self._planes(index)
        self.stats["fused_scans"] += 1
        shards = [(slabs if planes == (0, 1)
                   else slabs[planes[0]:planes[0] + 1], valid)
                  for slabs, valid in self.shards]
        if self.mesh_nodes > 1:
            return self._scan_mesh(q, node_ids, k, shards, mask_nodes,
                                   per_node)
        (slabs, valid), = shards
        if per_node:
            scan = ops.vdb_topk_pernode if self.use_pallas \
                else ref.vdb_topk_pernode_ref
            s, i = scan(q, slabs, valid, k)
        else:
            nids = torch.as_tensor(np.asarray(node_ids, np.int32),
                                   device=slabs.device)
            scan = ops.vdb_topk_sharded if self.use_pallas \
                else ref.vdb_topk_sharded_ref
            s, i = scan(q, slabs, valid, nids, k, mask_nodes=mask_nodes)
        return s.cpu().numpy(), i.cpu().numpy()

    def _scan_mesh(self, q, node_ids, k: int, shards, mask_nodes: bool,
                   per_node: bool):
        """Mesh body of :meth:`_scan`: each shard scans its own nodes on
        its device; only the per-shard best-k lists come back (counted in
        ``stats["allgather_bytes"]``), and the global modes merge them
        with the one-device tie-break."""
        if per_node:
            s, i = ops.vdb_topk_pernode_mesh(q, shards, k,
                                             use_pallas=self.use_pallas)
            self.stats["allgather_bytes"] += s.nbytes + i.nbytes
            # pad nodes are all-invalid — drop their masked rows
            return s[:, :self.n_nodes], i[:, :self.n_nodes]
        # per-shard k never exceeds the shard's own candidate count; the
        # merged pool (mesh_nodes x k_local) still holds >= k candidates
        k_local = min(k, self.n_shard * self.capacity)
        s, i = ops.vdb_topk_sharded_mesh(q, shards, node_ids, k_local,
                                         mask_nodes=mask_nodes,
                                         use_pallas=self.use_pallas)
        self.stats["allgather_bytes"] += s.nbytes + i.nbytes
        return ops.merge_shard_topk(s, i, k)

    def search_batch(self, query_vecs: np.ndarray, node_ids: Sequence[int],
                     k: int, *, index: str = "both",
                     count_queries: bool = True,
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Fused cross-node dual ANN retrieval: every query against its
        scheduled node, both indexes, ONE device scan for the whole
        micro-batch.  Returns one ``(scores, slots)`` pair per query with
        ``VectorDB.search`` semantics (deduped union across indexes,
        masked candidates dropped, scores descending, slots LOCAL to the
        query's node)."""
        q, b = self._prep_queries(query_vecs)
        if b == 0:
            return []
        nids = np.asarray(list(node_ids), np.int32)
        if count_queries:
            for ni in nids:
                if self.dbs[ni] is not None:
                    self.dbs[ni].query_count += 1
        k = min(k, self.capacity)
        s, i = self._scan(q, nids, k, index, mask_nodes=True)
        return [_union_topk(list(s[:, row]),
                            list(i[:, row] - nids[row] * self.capacity))
                for row in range(b)]

    def search_cluster(self, query_vecs: np.ndarray, k: int, *,
                       index: str = "both",
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """All-nodes flat mode: each query scans the WHOLE cluster and
        gets ONE global candidate list; slots are global ids
        ``node * capacity + col``."""
        q, b = self._prep_queries(query_vecs)
        if b == 0:
            return []
        k = min(k, self.capacity * max(self.n_nodes, 1))
        s, i = self._scan(q, np.zeros(b, np.int32), k, index,
                          mask_nodes=False)
        return [_union_topk(list(s[:, row]), list(i[:, row]))
                for row in range(b)]

    def search_cluster_nodes(self, query_vecs: np.ndarray, k: int, *,
                             index: str = "both",
                             ) -> List[List[Tuple[np.ndarray, np.ndarray]]]:
        """All-nodes PER-NODE mode — the schedule+retrieve fusion scan.
        Returns ``out[query][node] = (scores, slots)`` with exactly
        :meth:`VectorDB.search` semantics per node (slots LOCAL to that
        node), from ONE device launch."""
        q, b = self._prep_queries(query_vecs)
        if b == 0:
            return []
        k = min(k, self.capacity)
        s, i = self._scan(q, None, k, index, mask_nodes=False,
                          per_node=True)         # (planes, nodes, Q, k)
        return [[_union_topk(list(s[:, node, row]),
                             list(i[:, node, row] - node * self.capacity))
                 for node in range(self.n_nodes)]
                for row in range(b)]

    # -- derived state ------------------------------------------------------

    def node_vectors(self) -> np.ndarray:
        """L2-normalised node representation vectors (Eq. 6) from the
        per-db running centroids — O(nodes·dim), no slab reduction.
        Delegates to the scheduler's single implementation."""
        from repro_torch.core.scheduler import RequestScheduler
        return RequestScheduler.node_vectors(
            [db if db is not None else VectorDB(self.dim, 0, device="cpu")
             for db in self.dbs])

    # -- introspection (tests / debugging) ----------------------------------

    def device_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """Device slabs/validity pulled to host, the shards joined along
        the node axis and the mesh's pad nodes cut off, so that it
        compares directly against :meth:`rebuild_reference` at any mesh
        size."""
        slabs = torch.cat([s.cpu() for s, _ in self.shards],
                          dim=partition.SLAB_NODE_AXIS)
        valid = torch.cat([v.cpu() for _, v in self.shards],
                          dim=partition.VALID_NODE_AXIS)
        return (slabs[:, :self.n_nodes].numpy(),
                valid[:self.n_nodes].numpy())

    def rebuild_reference(self) -> Tuple[np.ndarray, np.ndarray]:
        """What the device state SHOULD be, rebuilt from the numpy views
        (parity oracle for the incremental-update tests)."""
        img = np.zeros((self.n_nodes, self.capacity, self.dim), np.float32)
        txt = np.zeros_like(img)
        val = np.zeros((self.n_nodes, self.capacity), bool)
        for ni, db in enumerate(self.dbs):
            if db is None:
                continue
            img[ni, :db.capacity] = db.img_vecs
            txt[ni, :db.capacity] = db.txt_vecs
            val[ni, :db.capacity] = db.valid
        return np.stack([img, txt]), val
