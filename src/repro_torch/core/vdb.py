"""In-framework vector database (paper's pgvector equivalent, §IV-C/§IV-F)
— the port of the JAX package's ``repro/core/vdb.py``.

One ``VectorDB`` instance per edge node.  Each entry carries BOTH the image
embedding and the caption/text embedding (the paper's dual ANN retrieval,
Algorithm 1 lines 2-3), plus the bookkeeping the eviction policies need
(insert time, access counts, last access).

Storage layout is a fixed-capacity slab of numpy arrays with a validity
mask — the HOST source of truth for snapshot/restore, eviction and the
storage classifier.  A db registered with a
:class:`repro_torch.core.cluster_index.ClusterIndex` is a per-node VIEW
over the cluster's device-resident stacked slabs — every ``add``/``evict``
pushes an incremental row update, and ``search``/``search_batch``
delegate to the fused cross-node scan (the CUDA kernels on the card).
A standalone db (no cluster) uploads its host slab to its ``device`` per
call and scans it once per index, through the single-slab kernel
(``ops.vdb_topk``: the CUDA kernel on the card, the plain version on the
CPU) when ``use_pallas`` is set, else through the plain scan on that
device.

``payload_ids`` are opaque ints pointing into a :class:`BlobStore` (the
paper's NFS layer).
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import vdb_topk_ref

# The CUDA kernel uses a large-negative sentinel instead of -inf; treat
# anything at or below it as "masked" when unioning candidate sets.
_SCORE_FLOOR = -1e29


class BlobStore:
    """The shared image store (paper: 500GB NFS PersistentVolume).

    Every ``put`` records the blob's CRC32 so hits can be verified before
    a cached/reference image is ever conditioned on (``verify`` — the
    Plan stage's verify-on-hit path; see ``repro_torch.core.pipeline``).
    ``corrupt`` is the deterministic chaos surface: it perturbs the
    stored pixels WITHOUT refreshing the checksum, modelling silent NFS
    bit-rot that only a verify-on-hit can catch."""

    def __init__(self):
        self._blobs: Dict[int, np.ndarray] = {}
        self._sums: Dict[int, int] = {}
        self._next = 0

    def put(self, blob: np.ndarray) -> int:
        bid = self._next
        self._next += 1
        blob = np.asarray(blob)
        self._blobs[bid] = blob
        self._sums[bid] = zlib.crc32(blob.tobytes())
        return bid

    def get(self, bid: int) -> np.ndarray:
        return self._blobs[bid]

    def delete(self, bid: int) -> None:
        self._blobs.pop(bid, None)
        self._sums.pop(bid, None)

    def verify(self, bid: int) -> bool:
        """True iff the blob exists and its bytes still match the
        checksum recorded at ``put`` time."""
        blob = self._blobs.get(bid)
        if blob is None:
            return False
        return zlib.crc32(blob.tobytes()) == self._sums.get(bid)

    def corrupt(self, bid: int, rng: Optional[np.random.Generator] = None,
                ) -> None:
        """Deterministically damage a stored blob in place (chaos/test
        surface): a seeded perturbation of its pixels, leaving the
        recorded checksum stale so ``verify`` fails."""
        blob = self._blobs.get(bid)
        if blob is None:
            return
        rng = rng or np.random.default_rng(bid)
        noisy = np.asarray(blob, np.float32).copy()
        flat = noisy.reshape(-1)
        idx = rng.integers(0, flat.size, size=max(1, flat.size // 16))
        flat[idx] += rng.standard_normal(len(idx)).astype(np.float32) * 8.0
        self._blobs[bid] = noisy.reshape(np.shape(blob))

    def __len__(self) -> int:
        return len(self._blobs)

    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._blobs.values())


def _l2n(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _union_topk(score_rows: Sequence[np.ndarray],
                slot_rows: Sequence[np.ndarray],
                ) -> Tuple[np.ndarray, np.ndarray]:
    """De-duplicate the union of per-index top-k rows, keeping the best
    score per slot and dropping masked candidates (±inf or the Pallas
    large-negative sentinel).

    Fully vectorised (no per-candidate Python loop): one lexsort groups
    candidates by slot with scores descending, so the first entry of each
    group IS the best score for that slot (ties keep the earliest row —
    the img index before txt — matching the old strict ``>`` dict
    update); a final stable sort restores descending-score order with
    slot-ascending tie-break.
    """
    if score_rows:
        scores = np.concatenate(
            [np.asarray(s, np.float32).ravel() for s in score_rows])
        slots = np.concatenate(
            [np.asarray(s).ravel() for s in slot_rows]).astype(np.int64)
    else:
        scores = np.empty((0,), np.float32)
        slots = np.empty((0,), np.int64)
    keep = np.isfinite(scores) & (scores > _SCORE_FLOOR)
    scores, slots = scores[keep], slots[keep]
    if scores.size == 0:
        return np.empty((0,), np.float32), np.empty((0,), np.int64)
    order = np.lexsort((-scores, slots))        # slot asc, score desc, stable
    slots_s, scores_s = slots[order], scores[order]
    first = np.ones(len(slots_s), bool)
    first[1:] = slots_s[1:] != slots_s[:-1]     # best entry per slot
    slots_u, scores_u = slots_s[first], scores_s[first]
    out = np.argsort(-scores_u, kind="stable")  # desc; ties -> slot asc
    return scores_u[out], slots_u[out]


class VectorDB:
    """Fixed-capacity dual-index vector DB for one edge node."""

    def __init__(self, dim: int, capacity: int, *, name: str = "node",
                 use_pallas: bool = True, device="cuda"):
        self.dim = dim
        self.capacity = capacity
        self.name = name
        # scans run through the CUDA kernels (True, the port's default;
        # the JAX package defaults to False) or the plain PyTorch scan
        # (False): a cluster index built over this db follows this flag,
        # and a standalone db scans on ``device``
        self.use_pallas = use_pallas
        self.device = torch.device(device)
        self.img_vecs = np.zeros((capacity, dim), np.float32)
        self.txt_vecs = np.zeros((capacity, dim), np.float32)
        self.valid = np.zeros((capacity,), bool)
        self.insert_time = np.full((capacity,), -1.0, np.float64)
        self.last_access = np.full((capacity,), -1.0, np.float64)
        self.access_count = np.zeros((capacity,), np.int64)
        self.payload_ids = np.full((capacity,), -1, np.int64)
        # latent-depth cache metadata (host-side slab columns; the fused
        # device scans never consume them, so scans stay one-launch):
        # ``depth`` = resume depth of a noised-latent entry, -1 for a
        # finished image; ``source_id`` groups every entry archived from
        # one generation (the finished image's payload id)
        self.depth = np.full((capacity,), -1, np.int64)
        self.source_id = np.full((capacity,), -1, np.int64)
        self.query_count = 0
        # running centroid (sum of valid img vectors + count), maintained
        # on every mutation so centroid() is O(dim), not O(capacity*dim)
        self._cent_sum = np.zeros((dim,), np.float64)
        self._cent_count = 0
        # ClusterIndex views over this node's slab (usually 0 or 1)
        self._clusters: List[Tuple[object, int]] = []
        # durability journal (repro_torch.core.journal) — every mutation below
        # records its RAW arguments before the slab changes
        self._journal = None

    # -- durability journal -------------------------------------------------

    def attach_journal(self, journal) -> None:
        """Attach a :class:`repro_torch.core.journal.CacheJournal`: every
        ``add`` / ``evict_slots`` / ``mark_access`` appends one WAL
        record (raw call arguments) BEFORE mutating the slab, so a crash
        at any instant replays to exactly the pre-crash state."""
        self._journal = journal
        journal.bind(self)

    def detach_journal(self):
        j, self._journal = self._journal, None
        return j

    # -- cluster registration ----------------------------------------------

    def register_cluster(self, cluster, node: int) -> None:
        """Attach a ClusterIndex view; future mutations push incremental
        device row updates, and searches delegate to the fused scan.
        EVERY registered cluster receives updates (two systems sharing a
        fleet each keep their own index in sync — including a sharded
        and an unsharded index side by side, as the parity tests do; on
        a mesh-sharded index the donated scatter routes each row to the
        node's owning shard); drop indexes you are done with via
        :meth:`unregister_cluster` or they stay live."""
        self._clusters = [(c, n) for c, n in self._clusters
                          if c is not cluster] + [(cluster, node)]

    def unregister_cluster(self, cluster) -> None:
        self._clusters = [(c, n) for c, n in self._clusters
                          if c is not cluster]

    def _cluster_update(self, slots: np.ndarray) -> None:
        for cluster, node in self._clusters:
            cluster.update_rows(node, slots, self.img_vecs[slots],
                                self.txt_vecs[slots])

    def _cluster_invalidate(self, slots: np.ndarray) -> None:
        for cluster, node in self._clusters:
            cluster.invalidate_rows(node, slots)

    # -- mutation ----------------------------------------------------------

    def add(self, img_vecs: np.ndarray, txt_vecs: np.ndarray,
            payload_ids: np.ndarray, t: float, *,
            depths: Optional[np.ndarray] = None,
            source_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert a batch; overwrite oldest entries if full (FIFO pressure
        valve — the real policy runs via :mod:`repro_torch.core.lcu`).

        ``depths``/``source_ids`` carry the latent-depth cache metadata:
        depth -1 (the default) marks a finished image, k >= 0 a noised
        latent resumable at chain depth k; ``source_ids`` defaults to
        ``payload_ids`` (every finished image is its own source)."""
        if self._journal is not None:   # WAL: raw args, before mutation
            self._journal.record_add(img_vecs, txt_vecs, payload_ids, t,
                                     depths, source_ids)
        img_vecs = _l2n(np.atleast_2d(np.asarray(img_vecs, np.float32)))
        txt_vecs = _l2n(np.atleast_2d(np.asarray(txt_vecs, np.float32)))
        payload_ids = np.atleast_1d(np.asarray(payload_ids, np.int64))
        depths = (np.full(payload_ids.shape, -1, np.int64) if depths is None
                  else np.atleast_1d(np.asarray(depths, np.int64)))
        source_ids = (payload_ids if source_ids is None
                      else np.atleast_1d(np.asarray(source_ids, np.int64)))
        n = img_vecs.shape[0]
        if n > self.capacity:    # oversized insert: only the NEWEST
            drop = n - self.capacity         # capacity rows land (FIFO)
            img_vecs = img_vecs[drop:]
            txt_vecs = txt_vecs[drop:]
            payload_ids = payload_ids[drop:]
            depths = depths[drop:]
            source_ids = source_ids[drop:]
            n = self.capacity
        free = np.flatnonzero(~self.valid)
        if len(free) < n:  # overwrite the oldest VALID entries only
            valid_slots = np.flatnonzero(self.valid)
            oldest = valid_slots[np.argsort(self.insert_time[valid_slots])]
            free = np.concatenate([free, oldest[: n - len(free)]])
        slots = free[:n]     # free ∪ oldest-valid are disjoint: no dupes
        # running centroid: overwritten live rows leave, new rows enter
        live = slots[self.valid[slots]]
        if len(live):
            self._cent_sum -= self.img_vecs[live].sum(axis=0)
            self._cent_count -= len(live)
        self.img_vecs[slots] = img_vecs
        self.txt_vecs[slots] = txt_vecs
        self.valid[slots] = True
        self.insert_time[slots] = t
        self.last_access[slots] = t
        # fresh entries start at 1, not 0: insertion IS one use.  At 0 a
        # just-inserted row tied as most-evictable under LFU, so a sweep
        # right after insertion evicted the newest rows first and the
        # cache could never learn.
        self.access_count[slots] = 1
        self.payload_ids[slots] = payload_ids
        self.depth[slots] = depths
        self.source_id[slots] = source_ids
        self._cent_sum += self.img_vecs[slots].sum(axis=0)
        self._cent_count += len(slots)
        self._cluster_update(slots)
        return slots

    def evict_slots(self, slots: np.ndarray) -> np.ndarray:
        """Invalidate slots; returns the payload ids to delete from the blob
        store (the paper synchronously removes image files for consistency)."""
        if self._journal is not None:
            self._journal.record_evict(slots)
        slots = np.atleast_1d(np.asarray(slots))
        payloads = self.payload_ids[slots].copy()
        uniq = np.unique(slots)
        live = uniq[self.valid[uniq]]
        if len(live):
            self._cent_sum -= self.img_vecs[live].sum(axis=0)
            self._cent_count -= len(live)
        self.valid[slots] = False
        self.payload_ids[slots] = -1
        self.depth[slots] = -1
        self.source_id[slots] = -1
        self._cluster_invalidate(uniq)
        return payloads

    def mark_access(self, slots: np.ndarray, t: float) -> None:
        if self._journal is not None:
            self._journal.record_access(slots, t)
        slots = np.atleast_1d(np.asarray(slots))
        self.access_count[slots] += 1
        self.last_access[slots] = t

    # -- search ------------------------------------------------------------

    def search(self, query_vec: np.ndarray, k: int,
               *, index: str = "both") -> Tuple[np.ndarray, np.ndarray]:
        """Dual ANN retrieval (Algorithm 1 lines 2-4).

        Returns (scores, slots) of up to 2k unioned candidates (or k when a
        single index is selected); invalid slots get score=-inf.
        """
        self.query_count += 1
        q = _l2n(np.asarray(query_vec, np.float32).reshape(-1))
        k = min(k, self.capacity)
        if self._clusters:
            # cluster view: the slab is device-resident — fused masked
            # scan instead of re-uploading numpy arrays
            cluster, node = self._clusters[-1]
            return cluster.search_batch(q[None], [node], k, index=index,
                                        count_queries=False)[0]
        out = [(s[0], i[0]) for s, i in self._scan(q[None], k, index)]
        return _union_topk([o[0] for o in out], [o[1] for o in out])

    def search_batch(self, query_vecs: np.ndarray, k: int,
                     *, index: str = "both",
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Multi-query dual ANN retrieval — one device scan for the whole
        micro-batch.

        When this db is a ClusterIndex view the scan runs against the
        device-resident stacked slab (no host→device copies).  Standalone,
        it is one scan of the whole (Q, D) query block per index on
        ``device`` (:meth:`_scan`).

        Returns one ``(scores, slots)`` pair per query, each identical in
        meaning to :meth:`search` (deduped union across indexes, invalid
        slots dropped, scores descending).
        """
        Q = np.atleast_2d(np.asarray(query_vecs, np.float32))
        b = Q.shape[0]
        self.query_count += b
        if b == 0:
            return []
        if self._clusters:
            cluster, node = self._clusters[-1]
            return cluster.search_batch(Q, [node] * b, min(k, self.capacity),
                                        index=index, count_queries=False)
        per_index = self._scan(_l2n(Q), min(k, self.capacity), index)
        return [_union_topk([s[row] for s, _ in per_index],
                            [i[row] for _, i in per_index])
                for row in range(b)]

    def _scan(self, queries: np.ndarray, k: int, index: str,
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Masked cosine top-k of L2-normalised host ``queries`` (Q, d)
        against each selected index of the host slab, on ``device``: the
        queries, the validity mask and each index's rows are uploaded
        (once per call) and scanned by the single-slab kernel
        (``use_pallas``) or the plain scan.  Returns one
        ``(scores, slots)`` pair of (Q, k) host arrays per index, img
        before txt."""
        dev = self.device
        scan = ops.vdb_topk if self.use_pallas else vdb_topk_ref
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
        valid = torch.from_numpy(self.valid).to(dev)
        out = []
        for vecs, name in ((self.img_vecs, "img"), (self.txt_vecs, "txt")):
            if index in (name, "both"):
                s, i = scan(q, torch.from_numpy(vecs).to(dev), valid, k)
                out.append((s.cpu().numpy(), i.cpu().numpy()))
        return out

    # -- stats -------------------------------------------------------------

    @property
    def size(self) -> int:
        return int(self.valid.sum())

    def centroid(self) -> np.ndarray:
        """Node representation vector = mean of stored image vectors (§IV-E).

        O(dim): served from the running sum/count maintained on every
        ``add``/``evict_slots`` (float64 accumulation; recomputed — i.e.
        invalidated — on ``restore``), so ``schedule_batch`` no longer
        pays an O(capacity·dim) reduction per node per micro-batch."""
        if self._cent_count <= 0:
            return np.zeros((self.dim,), np.float32)
        return (self._cent_sum / self._cent_count).astype(np.float32)

    def _recompute_centroid(self) -> None:
        """Rebuild the running centroid from the slab (restore / any
        out-of-band mutation of ``img_vecs``/``valid``)."""
        self._cent_count = int(self.valid.sum())
        self._cent_sum = (self.img_vecs[self.valid].astype(np.float64)
                          .sum(axis=0) if self._cent_count
                          else np.zeros((self.dim,), np.float64))

    def snapshot(self) -> dict:
        """Serializable state (for checkpoint / node-failure recovery)."""
        return {
            "img_vecs": self.img_vecs.copy(), "txt_vecs": self.txt_vecs.copy(),
            "valid": self.valid.copy(), "insert_time": self.insert_time.copy(),
            "last_access": self.last_access.copy(),
            "access_count": self.access_count.copy(),
            "payload_ids": self.payload_ids.copy(),
            "depth": self.depth.copy(), "source_id": self.source_id.copy(),
        }

    @classmethod
    def restore(cls, dim: int, capacity: int, state: dict, **kw) -> "VectorDB":
        """A db holding a :meth:`snapshot`; ``kw`` are the constructor's
        (``name``, ``use_pallas``, ``device``)."""
        db = cls(dim, capacity, **kw)
        for k_, v in state.items():
            setattr(db, k_, v.copy())
        db._recompute_centroid()    # cache is invalid for the new slab
        return db
