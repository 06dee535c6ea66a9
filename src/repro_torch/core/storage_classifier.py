"""Storage classifier (paper §IV-C): cluster the corpus, one cluster per node.

The port of the JAX package's ``repro/core/storage_classifier.py``.
K-means over the corpus *image* embeddings (the paper clusters both
modalities, observes high cross-modal consistency — Fig. 6b — and picks the
image-vector clustering for placement); cluster i's vectors are inserted
into edge node i's VDB.  The classifier also owns the fitted centroids so
that (a) the request scheduler can route by centroid similarity and (b) a
failed node's shard can be reassigned to the nearest surviving centroid.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans_assign, kmeans_fit
from repro_torch.core.vdb import VectorDB


class StorageClassifier:
    def __init__(self, n_nodes: int, *, iters: int = 25, device="cuda"):
        self.n_nodes = n_nodes
        self.iters = iters
        self.device = torch.device(device)   # where K-means runs
        self.centroids: Optional[np.ndarray] = None  # (n_nodes, d)
        # node index owning each centroid row — failures drop rows, so
        # after the first reassignment row i is NOT node i anymore
        self.centroid_nodes: List[int] = list(range(n_nodes))
        self.modal_consistency: Optional[float] = None

    def fit(self, img_vecs: np.ndarray, txt_vecs: Optional[np.ndarray] = None,
            ) -> np.ndarray:
        """Cluster image vectors into n_nodes clusters; returns assignment.

        If text vectors are given, also measures image/text cluster
        consistency (the paper's Fig. 6b argument for using image vectors).
        """
        state = kmeans_fit(self._tensor(img_vecs), k=self.n_nodes,
                           iters=self.iters)
        self.centroids = state.centroids.cpu().numpy()
        self.centroid_nodes = list(range(self.n_nodes))
        assignment = state.assignment.cpu().numpy()
        if txt_vecs is not None:
            t_state = kmeans_fit(self._tensor(txt_vecs), k=self.n_nodes,
                                 iters=self.iters)
            self.modal_consistency = _cluster_agreement(
                assignment, t_state.assignment.cpu().numpy(), self.n_nodes)
        return assignment

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _assign(self, vecs: np.ndarray, centroids: np.ndarray) -> np.ndarray:
        idx, _ = kmeans_assign(self._tensor(vecs), self._tensor(centroids))
        return idx.cpu().numpy()

    def assign(self, img_vecs: np.ndarray) -> np.ndarray:
        if self.centroids is None:
            raise RuntimeError("fit() first")
        return self._assign(img_vecs, self.centroids)

    def build_node_dbs(self, img_vecs: np.ndarray, txt_vecs: np.ndarray,
                       payload_ids: np.ndarray, *, capacity_per_node: int,
                       use_pallas: bool = True, t0: float = 0.0,
                       ) -> List[VectorDB]:
        """Fit + materialise the per-node VDBs (data-preprocessing phase);
        a standalone db scans on the classifier's device."""
        assignment = self.fit(img_vecs, txt_vecs)
        dbs = []
        for ni in range(self.n_nodes):
            db = VectorDB(img_vecs.shape[-1], capacity_per_node,
                          name=f"node{ni}", use_pallas=use_pallas,
                          device=self.device)
            sel = np.flatnonzero(assignment == ni)
            if sel.size:
                # Respect capacity at build time; the LCU policy maintains it after.
                sel = sel[:capacity_per_node]
                db.add(img_vecs[sel], txt_vecs[sel], payload_ids[sel], t=t0)
            dbs.append(db)
        return dbs

    def reassign_failed_node(self, dbs: Sequence[VectorDB], failed: int,
                             t: float,
                             survivors: Optional[Sequence[int]] = None,
                             ) -> None:
        """Node-failure recovery: move the failed node's entries to the
        nearest surviving centroid's VDB and drop the failed centroid.

        ``centroid_nodes`` maps centroid rows back to node indices —
        failures drop rows, so after one failure row i no longer belongs
        to node i and a second failure must look its row up.  ``survivors``
        restricts receivers (callers pass the ALIVE fleet so entries are
        never reassigned onto an earlier casualty); default: every node
        that still owns a centroid row, minus ``failed``."""
        if self.centroids is None:
            raise RuntimeError("fit() first")
        db = dbs[failed]
        if survivors is None:
            survivors = [n for n in self.centroid_nodes if n != failed]
        surv_rows = [r for r, n in enumerate(self.centroid_nodes)
                     if n in set(survivors) and n != failed]
        surv_nodes = [self.centroid_nodes[r] for r in surv_rows]
        if not surv_nodes:
            return
        surv_cents = self.centroids[surv_rows]
        sel = np.flatnonzero(db.valid)
        if sel.size:
            idx = self._assign(db.img_vecs[sel], surv_cents)
            for j, ni in enumerate(surv_nodes):
                pick = sel[idx == j]
                if pick.size:
                    dbs[ni].add(db.img_vecs[pick], db.txt_vecs[pick],
                                db.payload_ids[pick], t=t)
            db.evict_slots(sel)
        keep = [r for r, n in enumerate(self.centroid_nodes) if n != failed]
        self.centroids = self.centroids[keep]
        self.centroid_nodes = [self.centroid_nodes[r] for r in keep]


def _cluster_agreement(a: np.ndarray, b: np.ndarray, k: int) -> float:
    """Best-match overlap between two clusterings (greedy Hungarian-ish)."""
    conf = np.zeros((k, k), np.int64)
    for i, j in zip(a, b):
        conf[i, j] += 1
    total = len(a)
    agree = 0
    used = set()
    for i in np.argsort(-conf.max(axis=1)):
        j = int(np.argmax(np.where(np.isin(np.arange(k), list(used)),
                                   -1, conf[i])))
        used.add(j)
        agree += conf[i, j]
    return agree / max(total, 1)
