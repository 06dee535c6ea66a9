"""The cache durability journal, the port against the JAX package, on the
CPU.

* The same seeded stream of ``add`` / ``evict_slots`` / ``mark_access``
  through a JAX ``VectorDB`` + ``CacheJournal`` and through the port's:
  at every probe point both replays equal both live dbs, bitwise, and
  the two journal directories hold the same files.
* The on-disk format is the state carried across: a directory written by
  the JAX package replays in the port, and the other way round, bitwise.
* The journal's own contract on the port: base snapshot of pre-attach
  state, snapshot pruning, the deferred auto-snapshot, in-flight
  ``*.tmp`` artefacts ignored, an unknown record kind rejected, and a
  replayed db that keeps journaling.

Discrete and float state alike is held bitwise: replay re-runs the same
numpy mutation code in both packages."""
from __future__ import annotations

import os

import numpy as np
import pytest

from repro.core.journal import CacheJournal as JJournal
from repro.core.vdb import VectorDB as JVectorDB
from repro_torch.core.journal import CacheJournal
from repro_torch.core.vdb import VectorDB

DIM = 16


def _port_db(capacity, **kw):
    return VectorDB(DIM, capacity, device="cpu", **kw)


def _rand_op(db, rng: np.random.Generator, t: float) -> None:
    """One random mutation drawn from the live-serving distribution (the
    reference test's stream: FIFO overwrite under pressure, evictions of
    dead slots, repeated accesses)."""
    kind = rng.choice(["add", "add", "evict", "access", "access"])
    valid = np.flatnonzero(db.valid)
    if kind != "add" and len(valid) == 0:
        kind = "add"
    if kind == "add":
        n = int(rng.integers(1, 4))
        depths = (rng.integers(-1, 6, size=n)
                  if rng.random() < 0.5 else None)
        db.add(rng.standard_normal((n, DIM)).astype(np.float32),
               rng.standard_normal((n, DIM)).astype(np.float32),
               rng.integers(0, 10_000, size=n), t, depths=depths,
               source_ids=(rng.integers(0, 10_000, size=n)
                           if rng.random() < 0.5 else None))
    elif kind == "evict":
        k = int(rng.integers(1, min(3, len(valid)) + 1))
        slots = rng.choice(valid, size=k, replace=False)
        if rng.random() < 0.2:
            slots = np.append(slots, rng.integers(0, db.capacity))
        db.evict_slots(slots)
    else:
        k = int(rng.integers(1, min(4, len(valid)) + 1))
        db.mark_access(rng.choice(valid, size=k, replace=False), t)


def _assert_bitwise(a, b) -> None:
    sa, sb = a.snapshot(), b.snapshot()
    assert set(sa) == set(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _listing(root) -> list:
    return sorted(os.listdir(root))


@pytest.mark.parametrize("seed,snapshot_every",
                         [(0, 8), (1, 5), (2, 0), (3, 1), (4, 64), (5, 3)])
def test_replays_equal_jax_through_random_stream(tmp_path, seed,
                                                 snapshot_every):
    """At every probe point of one random stream, applied to a JAX db and
    a port db with their own journals: the two live dbs, the two replays
    and the two directories agree."""
    jdb, tdb = JVectorDB(DIM, 24, name="n0"), _port_db(24, name="n0")
    jj = JJournal(str(tmp_path / "jax"), snapshot_every=snapshot_every)
    tj = CacheJournal(str(tmp_path / "port"), snapshot_every=snapshot_every)
    jdb.attach_journal(jj)
    tdb.attach_journal(tj)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    probes = set(rj.integers(1, 100, size=8).tolist()) | {99}
    rt.integers(1, 100, size=8)
    for i in range(100):
        _rand_op(jdb, rj, t=float(i))
        _rand_op(tdb, rt, t=float(i))
        if i in probes:
            _assert_bitwise(jdb, tdb)
            t_rep = tj.replay(DIM, 24, name="n0", device="cpu")
            _assert_bitwise(tdb, t_rep)
            _assert_bitwise(jj.replay(DIM, 24, name="n0"), t_rep)
            assert _listing(tj.root) == _listing(jj.root)
            assert tj.seq == jj.seq
    assert isinstance(t_rep, VectorDB)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("snapshot_every", [0, 6])
def test_journal_directory_replays_across_packages(tmp_path, writer,
                                                   snapshot_every):
    """A journal written by one package (a base snapshot of pre-attach
    state, then WAL records and auto-snapshots) replays in the other to
    the writer's live db, bitwise; the reader's journal resumes at the
    writer's sequence number and keeps journaling into the directory."""
    rng = np.random.default_rng(11 + snapshot_every)
    make_db, make_j = ((lambda: JVectorDB(DIM, 20, name="n1"), JJournal)
                       if writer == "jax" else
                       (lambda: _port_db(20, name="n1"), CacheJournal))
    live = make_db()
    for i in range(4):                          # pre-attach content
        _rand_op(live, rng, t=float(i))
    j = make_j(str(tmp_path), snapshot_every=snapshot_every)
    live.attach_journal(j)
    j.snapshot()
    for i in range(4, 40):
        _rand_op(live, rng, t=float(i))
    if writer == "jax":
        reader = CacheJournal(str(tmp_path), snapshot_every=snapshot_every)
        got = reader.replay(DIM, 20, name="n1", device="cpu")
    else:
        reader = JJournal(str(tmp_path), snapshot_every=snapshot_every)
        got = reader.replay(DIM, 20, name="n1")
    assert reader.seq == j.seq
    _assert_bitwise(live, got)
    # the reader takes over the directory (a rejoin in the other package)
    got.attach_journal(reader)
    twin = (_port_db if writer == "port" else
            lambda c, **kw: JVectorDB(DIM, c, **kw))(20, name="n1")
    for k, v in live.snapshot().items():
        setattr(twin, k, v.copy())
    twin._recompute_centroid()
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(40, 55):
        _rand_op(got, r1, t=float(i))
        _rand_op(twin, r2, t=float(i))
    again = (JJournal if writer == "jax" else CacheJournal)(str(tmp_path))
    kw = {} if writer == "jax" else dict(device="cpu")
    _assert_bitwise(twin, again.replay(DIM, 20, name="n1", **kw))


def test_replay_passes_the_ports_db_keywords(tmp_path):
    db = _port_db(8, name="n2", use_pallas=False)
    j = CacheJournal(str(tmp_path), snapshot_every=2)
    db.attach_journal(j)
    rng = np.random.default_rng(2)
    for i in range(7):
        _rand_op(db, rng, t=float(i))
    got = j.replay(DIM, 8, name="n2", use_pallas=False, device="cpu")
    assert (got.name, got.use_pallas, str(got.device)) == ("n2", False,
                                                          "cpu")
    assert got._journal is None            # replay journals nothing
    _assert_bitwise(db, got)


def test_pre_attach_state_is_durable_via_base_snapshot(tmp_path):
    rng = np.random.default_rng(9)
    db = _port_db(16)
    db.add(rng.standard_normal((6, DIM)).astype(np.float32),
           rng.standard_normal((6, DIM)).astype(np.float32),
           np.arange(6), 0.0)
    j = CacheJournal(str(tmp_path), snapshot_every=0)
    db.attach_journal(j)
    j.snapshot()
    db.mark_access([0, 2], 1.0)
    db.evict_slots([1])
    _assert_bitwise(db, j.replay(DIM, 16, device="cpu"))


def test_snapshot_requires_bound_db(tmp_path):
    j = CacheJournal(str(tmp_path))
    with pytest.raises(RuntimeError, match="not bound"):
        j.snapshot()
    with pytest.raises(ValueError, match="snapshot_every"):
        CacheJournal(str(tmp_path), snapshot_every=-1)


def test_snapshot_prunes_absorbed_wal_and_old_snapshots(tmp_path):
    """Pruning leaves the same files as the JAX journal's on the same
    stream."""
    dirs = {}
    for name, db, jcls in (("port", _port_db(16), CacheJournal),
                           ("jax", JVectorDB(DIM, 16), JJournal)):
        root = tmp_path / name
        rng = np.random.default_rng(3)
        j = jcls(str(root), snapshot_every=0)
        db.attach_journal(j)
        for i in range(5):
            _rand_op(db, rng, t=float(i))
        first = j.snapshot()
        assert os.path.isdir(first)
        assert not [n for n in os.listdir(root) if n.startswith("wal_")]
        for i in range(3):
            _rand_op(db, rng, t=float(5 + i))
        assert len([n for n in os.listdir(root)
                    if n.startswith("wal_")]) == 3
        second = j.snapshot()
        assert os.path.isdir(second) and not os.path.isdir(first)
        dirs[name] = (_listing(root), db)
    assert dirs["port"][0] == dirs["jax"][0]
    _assert_bitwise(dirs["port"][1], dirs["jax"][1])


def test_deferred_auto_snapshot_never_loses_boundary_record(tmp_path):
    db = _port_db(16)
    j = CacheJournal(str(tmp_path), snapshot_every=2)
    db.attach_journal(j)
    vec = np.random.default_rng(0).standard_normal((1, DIM)).astype(
        np.float32)
    db.add(vec, vec, [7], 0.0)
    db.mark_access([0], 1.0)            # the cadence boundary
    assert j.replay(DIM, 16, device="cpu").access_count[0] == 2
    db.mark_access([0], 2.0)            # publishes records 1-2
    assert [n for n in os.listdir(tmp_path)
            if n.startswith("snap_")] == ["snap_0000000002"]
    _assert_bitwise(db, j.replay(DIM, 16, device="cpu"))


def test_replay_ignores_inflight_tmp_artifacts(tmp_path):
    rng = np.random.default_rng(4)
    db = _port_db(16)
    j = CacheJournal(str(tmp_path), snapshot_every=0)
    db.attach_journal(j)
    for i in range(4):
        _rand_op(db, rng, t=float(i))
    os.makedirs(tmp_path / "snap_0000000099.tmp")
    np.savez(tmp_path / "snap_0000000099.tmp" / "arrays.npz",
             junk=np.zeros(3))
    with open(tmp_path / "wal_0000000099.npz.tmp", "wb") as f:
        f.write(b"torn write")
    _assert_bitwise(db, j.replay(DIM, 16, device="cpu"))
    assert CacheJournal(str(tmp_path), snapshot_every=0).seq == j.seq
    # the JAX package reads the same directory the same way
    _assert_bitwise(db, JJournal(str(tmp_path)).replay(DIM, 16))


def test_replay_rejects_unknown_record_kind(tmp_path):
    db = _port_db(8)
    j = CacheJournal(str(tmp_path), snapshot_every=0)
    db.attach_journal(j)
    db.mark_access(np.array([], np.int64), 0.0)
    with open(tmp_path / "wal_0000000002.npz", "wb") as f:
        np.savez(f, kind=np.array("frobnicate"))
    with pytest.raises(ValueError, match="frobnicate"):
        j.replay(DIM, 8, device="cpu")


def test_restored_db_keeps_journaling_after_rejoin(tmp_path):
    rng = np.random.default_rng(5)
    db = _port_db(16)
    j = CacheJournal(str(tmp_path), snapshot_every=4)
    db.attach_journal(j)
    for i in range(10):
        _rand_op(db, rng, t=float(i))
    db.detach_journal()
    db2 = j.replay(DIM, 16, device="cpu")
    _assert_bitwise(db, db2)
    db2.attach_journal(j)
    for i in range(10, 20):
        _rand_op(db2, rng, t=float(i))
    _assert_bitwise(db2, j.replay(DIM, 16, device="cpu"))
