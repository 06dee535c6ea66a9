"""Per-node cache durability journal — WAL + periodic snapshot for VectorDB;
the port of the JAX package's ``repro/core/journal.py`` (numpy only, the
logic and the on-disk format unchanged, so a journal written by either
package replays in the other).

The paper's cache-hit serving economics (NIRVANA's argument, PAPERS.md)
collapse when an edge node restarts cold: every archived reference on
that node is gone and its share of the fleet hit-rate with it.  This
module makes a node's cache state DURABLE without changing a single
steady-state code path:

* every ``VectorDB`` mutation (``add`` / ``evict_slots`` / ``mark_access``)
  is appended to a write-ahead log as ONE record carrying the RAW call
  arguments (pre-normalisation — replay re-runs the real method, so the
  double L2-normalisation, FIFO overwrite walk and centroid bookkeeping
  are bit-for-bit the originals);
* every ``snapshot_every`` records the journal publishes a full
  ``VectorDB.snapshot()`` atomically (tmp dir + ``os.rename`` — the same
  crash-safe publish discipline as the reference's checkpoint manager) and
  prunes the WAL records the snapshot has absorbed; the publish is
  deferred to the NEXT mutation's hook so it never captures a state the
  just-logged record has not yet applied to;
* :meth:`CacheJournal.replay` rebuilds the db from the newest complete
  snapshot plus the WAL tail — bitwise-equal (every ``snapshot()`` array)
  to the live db at the instant of the last journaled mutation, which is
  the crash instant itself because records are written synchronously
  BEFORE the slab mutates.

Layout of one node's journal directory::

    <root>/wal_0000000042.npz     one mutation record (kind + raw args)
    <root>/snap_0000000040/       atomically published snapshot
        arrays.npz                VectorDB.snapshot() arrays
        manifest.json             {"seq": 40}
    <root>/snap_0000000040.tmp/   (in-flight write — ignored by replay)

Attach with ``db.attach_journal(CacheJournal(path))``; recover with
``CacheJournal(path).replay(dim, capacity)``.  The chaos harness
(``repro_torch.faults``) wires one journal per node and rejoins crashed
nodes through ``CacheGenius.rejoin_node`` with the replayed db.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["CacheJournal"]

_WAL_PREFIX = "wal_"
_SNAP_PREFIX = "snap_"


class CacheJournal:
    """Write-ahead log + periodic snapshot for one node's ``VectorDB``.

    ``snapshot_every`` bounds replay work: a restart reads one snapshot
    plus at most ``snapshot_every`` WAL records.  ``0`` disables periodic
    snapshots (pure WAL — replay walks every record since the last
    explicit :meth:`snapshot` call, if any).
    """

    def __init__(self, root: str, *, snapshot_every: int = 64):
        if snapshot_every < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {snapshot_every}")
        self.root = root
        self.snapshot_every = int(snapshot_every)
        os.makedirs(root, exist_ok=True)
        self._db = None                   # bound VectorDB (attach_journal)
        self.seq = self._latest_seq()     # last durable record number
        self._snap_seq = self._latest_snapshot()[0]   # newest snapshot seq

    # -- binding ------------------------------------------------------------

    def bind(self, db) -> None:
        """Called by ``VectorDB.attach_journal``; the bound db is the
        snapshot source."""
        self._db = db

    # -- record (called from the VectorDB mutation hooks) --------------------

    def record_add(self, img_vecs, txt_vecs, payload_ids, t,
                   depths, source_ids) -> None:
        rec = {"img_vecs": np.atleast_2d(np.asarray(img_vecs, np.float32)),
               "txt_vecs": np.atleast_2d(np.asarray(txt_vecs, np.float32)),
               "payload_ids": np.atleast_1d(np.asarray(payload_ids,
                                                       np.int64)),
               "t": np.float64(t)}
        if depths is not None:
            rec["depths"] = np.atleast_1d(np.asarray(depths, np.int64))
        if source_ids is not None:
            rec["source_ids"] = np.atleast_1d(np.asarray(source_ids,
                                                         np.int64))
        self._append("add", rec)

    def record_evict(self, slots) -> None:
        self._append("evict",
                     {"slots": np.atleast_1d(np.asarray(slots, np.int64))})

    def record_access(self, slots, t) -> None:
        self._append("access",
                     {"slots": np.atleast_1d(np.asarray(slots, np.int64)),
                      "t": np.float64(t)})

    def _append(self, kind: str, arrays: Dict[str, np.ndarray]) -> None:
        # Auto-snapshot is DEFERRED to the next mutation's append: the
        # hook that wrote record N runs BEFORE the db applies N, so
        # snapshotting inside that call would publish a state missing N's
        # effect while pruning N from the WAL — a lost mutation.  Here,
        # inside record N+1's hook, record N is guaranteed applied.
        if (self.snapshot_every and self._db is not None
                and self.seq > self._snap_seq
                and self.seq % self.snapshot_every == 0):
            self.snapshot()
        self.seq += 1
        path = os.path.join(self.root, f"{_WAL_PREFIX}{self.seq:010d}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:   # handle, not path: savez must not
            np.savez(f, kind=np.array(kind), **arrays)  # append ".npz"
        os.rename(tmp, path)     # a record is either whole or absent

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> str:
        """Publish the bound db's full state atomically at the current
        ``seq`` (checkpoint-manager discipline: write ``.tmp`` dir, then
        one ``os.rename``) and prune absorbed WAL records.  Returns the
        published directory."""
        if self._db is None:
            raise RuntimeError("journal is not bound to a VectorDB — "
                               "call db.attach_journal(journal) first")
        final = os.path.join(self.root, f"{_SNAP_PREFIX}{self.seq:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **self._db.snapshot())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"seq": self.seq}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._snap_seq = self.seq
        self._prune(self.seq)
        return final

    def _prune(self, upto: int) -> None:
        """Drop WAL records absorbed by the snapshot at ``upto`` and any
        older snapshots (the newest snapshot alone is the restart base)."""
        for name in os.listdir(self.root):
            if name.startswith(_WAL_PREFIX) and name.endswith(".npz"):
                if int(name[len(_WAL_PREFIX):-len(".npz")]) <= upto:
                    os.remove(os.path.join(self.root, name))
            elif (name.startswith(_SNAP_PREFIX) and not name.endswith(".tmp")
                  and int(name[len(_SNAP_PREFIX):]) < upto):
                shutil.rmtree(os.path.join(self.root, name))

    # -- replay --------------------------------------------------------------

    def _latest_seq(self) -> int:
        seqs = [0]
        for name in os.listdir(self.root):
            if name.startswith(_WAL_PREFIX) and name.endswith(".npz"):
                seqs.append(int(name[len(_WAL_PREFIX):-len(".npz")]))
            elif (name.startswith(_SNAP_PREFIX)
                  and not name.endswith(".tmp")):
                seqs.append(int(name[len(_SNAP_PREFIX):]))
        return max(seqs)

    def _latest_snapshot(self) -> Tuple[int, Optional[str]]:
        best, path = 0, None
        for name in os.listdir(self.root):
            if name.startswith(_SNAP_PREFIX) and not name.endswith(".tmp"):
                seq = int(name[len(_SNAP_PREFIX):])
                if seq >= best:
                    best, path = seq, os.path.join(self.root, name)
        return best, path

    def _wal_tail(self, after: int) -> List[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith(_WAL_PREFIX) and name.endswith(".npz"):
                if int(name[len(_WAL_PREFIX):-len(".npz")]) > after:
                    out.append(os.path.join(self.root, name))
        return out

    def replay(self, dim: int, capacity: int, *, name: str = "node",
               **db_kwargs):
        """Rebuild a ``VectorDB`` from the newest snapshot + WAL tail.

        Replay calls the REAL mutation methods (with no journal attached,
        so nothing re-journals), so every derived quantity — the slot
        choices of the FIFO overwrite walk, the double L2-normalisation,
        the fresh ``access_count`` — is recomputed by the same code that
        produced it live: the result is bitwise-equal to the live db's
        ``snapshot()`` at the last journaled mutation.  ``db_kwargs`` are
        the port's ``VectorDB`` keywords (``use_pallas``, ``device``)."""
        from repro_torch.core.vdb import VectorDB

        snap_seq, snap_path = self._latest_snapshot()
        if snap_path is not None:
            with np.load(os.path.join(snap_path, "arrays.npz")) as z:
                state = {k: z[k] for k in z.files}
            db = VectorDB.restore(dim, capacity, state, name=name,
                                  **db_kwargs)
        else:
            db = VectorDB(dim, capacity, name=name, **db_kwargs)
        for path in self._wal_tail(snap_seq):
            with np.load(path) as z:
                kind = str(z["kind"])
                rec = {k: z[k] for k in z.files if k != "kind"}
            if kind == "add":
                db.add(rec["img_vecs"], rec["txt_vecs"],
                       rec["payload_ids"], float(rec["t"]),
                       depths=rec.get("depths"),
                       source_ids=rec.get("source_ids"))
            elif kind == "evict":
                db.evict_slots(rec["slots"])
            elif kind == "access":
                db.mark_access(rec["slots"], float(rec["t"]))
            else:
                raise ValueError(f"unknown journal record kind {kind!r} "
                                 f"in {path}")
        return db
