"""Cache-maintenance policies (paper §IV-G, Algorithm 2).

LCU — Least Correlation Used — scores every cached vector by its euclidean
distance to the *current* semantic centre of its node's VDB and evicts the
farthest ("semantic outliers carry mixed concepts of limited reference
value").  LRU / LFU / FIFO are implemented on the same interface as the
paper's baselines (Fig. 19).

All policies operate across the fleet of node VDBs at once, exactly like
Algorithm 2: build one global list, sort by the policy key, pop until the
total size fits ``C_max``.

Per-depth utility (the latent-depth cache): noised-latent entries and
finished images compete under the SAME ``C_max``, but a deep latent is
cheap to store relative to the denoising steps it saves — so
``EvictionPolicy.maintain`` discounts every entry's eviction score by
``depth_weight · (depth / max_depth)`` of the policy's own score spread
(scale-free, so it composes with LCU distances, LFU counts and LRU/FIFO
clocks alike).  Finished images (depth -1) are untouched; with no latent
entries in the fleet the scores are bit-identical to the undepthed sort.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.vdb import VectorDB


class EvictionPolicy:
    name = "base"

    # eviction-score discount per unit of normalised resume depth: deep
    # latents save the most denoising steps per cached row, so they are
    # protected proportionally (0 disables per-depth utility entirely)
    depth_weight: float = 0.25

    def scores(self, db: VectorDB) -> np.ndarray:
        """Higher score = evicted earlier. Only valid slots are consulted."""
        raise NotImplementedError

    def depth_scores(self, db: VectorDB, depth_norm: int) -> np.ndarray:
        """Policy scores with the per-depth utility discount applied.

        The discount is ``depth_weight · (depth / depth_norm) · spread``
        where ``spread`` is the policy's own valid-score range on this db
        (1.0 when all scores tie, so depth still breaks ties) — scale-free
        across policies.  Finished images (depth < 0) and fleets with no
        latent entries (``depth_norm <= 0``) get the raw scores."""
        s = self.scores(db)
        if depth_norm <= 0 or self.depth_weight <= 0.0:
            return s
        finite = db.valid & np.isfinite(s)
        if not finite.any():
            return s
        spread = float(s[finite].max() - s[finite].min()) or 1.0
        frac = np.where(db.depth > 0, db.depth / float(depth_norm), 0.0)
        return np.where(finite, s - self.depth_weight * spread * frac, s)

    def maintain(self, dbs: Sequence[VectorDB], c_max: int,
                 ) -> Dict[int, np.ndarray]:
        """Algorithm 2: evict across all nodes until total size <= c_max.

        Returns {node_index: evicted payload ids}.
        """
        depth_norm = max((int(db.depth[db.valid].max(initial=-1))
                          for db in dbs), default=-1)
        entries: List[Tuple[float, int, int]] = []  # (score, node, slot)
        total = 0
        for ni, db in enumerate(dbs):
            total += db.size
            s = self.depth_scores(db, depth_norm)
            for slot in np.flatnonzero(db.valid):
                entries.append((float(s[slot]), ni, int(slot)))
        if total <= c_max:
            return {}
        entries.sort(key=lambda e: e[0], reverse=True)  # farthest first
        n_evict = total - c_max
        doomed: Dict[int, List[int]] = {}
        for score, ni, slot in entries[:n_evict]:
            doomed.setdefault(ni, []).append(slot)
        # one evict_slots call per node (one device validity update per
        # node when the db is a ClusterIndex view, not one per slot)
        return {ni: dbs[ni].evict_slots(np.array(slots, np.int64))
                          .astype(np.int64)
                for ni, slots in doomed.items()}


class LCUPolicy(EvictionPolicy):
    """Least Correlation Used: distance-to-centroid outlier eviction."""

    name = "LCU"

    def scores(self, db: VectorDB) -> np.ndarray:
        mu = db.centroid()
        d = np.linalg.norm(db.img_vecs - mu[None, :], axis=-1)
        return np.where(db.valid, d, -np.inf)


class LRUPolicy(EvictionPolicy):
    name = "LRU"

    def scores(self, db: VectorDB) -> np.ndarray:
        # least-recently-used = oldest last_access evicted first
        return np.where(db.valid, -db.last_access, -np.inf)


class LFUPolicy(EvictionPolicy):
    name = "LFU"

    def scores(self, db: VectorDB) -> np.ndarray:
        # equal-count ties break toward evicting the OLDER insert: counts
        # are integers >= 1 apart, and the bounded recency term lives in
        # [0, 0.5), so it reorders ties without ever flipping a count
        # ordering (newest rows no longer lose a tie to stale ones)
        t = np.maximum(db.insert_time, 0.0)
        recency = 0.5 * t / (1.0 + t)
        return np.where(db.valid,
                        -db.access_count.astype(np.float64) - recency,
                        -np.inf)


class FIFOPolicy(EvictionPolicy):
    name = "FIFO"

    def scores(self, db: VectorDB) -> np.ndarray:
        return np.where(db.valid, -db.insert_time, -np.inf)


POLICIES = {p.name: p for p in (LCUPolicy(), LRUPolicy(), LFUPolicy(), FIFOPolicy())}
