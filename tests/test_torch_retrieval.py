"""The port's retrieval layer (``repro_torch.core``: VectorDB,
ClusterIndex, K-means, StorageClassifier) against the JAX package's, on
the CPU, under the contracts of ``tests/test_cluster_index.py`` and
``tests/test_scheduling_score.py``.

Discrete outputs (slots, node assignments, validity, stats counters) must
be equal; scores agree to 1e-5 (two frameworks' f32 matmuls)."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core.cluster_index import ClusterIndex as JClusterIndex
from repro.core.embeddings import ProxyClipEmbedder
from repro.core.storage_classifier import StorageClassifier as JClassifier
from repro.core.vdb import VectorDB as JVectorDB
from repro.data.synthetic import make_corpus, render_caption
from repro.utils import l2n as jl2n
from repro.utils import next_pow2 as jnext_pow2
from repro.utils import stable_hash as jstable_hash
from repro_torch import utils as tutils
from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.storage_classifier import StorageClassifier
from repro_torch.core.trace import RequestTrace
from repro_torch.core.vdb import VectorDB
from repro_torch.launch.serve import build_system

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _unit(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mixed_fleet(cls, seed: int, dim: int = 24):
    """Empty, partial, exactly full and overfilled (FIFO overwrite)
    nodes with non-uniform capacities — built identically for either
    package's VectorDB class."""
    rng = np.random.default_rng(seed)
    kw = dict(device="cpu") if cls is VectorDB else {}
    dbs = [cls(dim, cap, name=name, **kw) for cap, name in (
        (32, "empty"), (32, "partial"), (16, "full"), (48, "overfull"))]
    for db, n in zip(dbs[1:], (10, 16, 60)):
        db.add(_unit(rng, n, dim), _unit(rng, n, dim), np.arange(n), 0.0)
    return dbs, rng


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for (g_s, g_l), (w_s, w_l) in zip(got, want):
        np.testing.assert_array_equal(g_l, w_l)
        np.testing.assert_allclose(g_s, w_s, **SCORE_TOL)


def test_utils_match_the_jax_package():
    for s in ("", "a red circle", "ünïcödé prompt", "x" * 300):
        for mod in (7, 1 << 20, 2 ** 61 - 1):
            assert tutils.stable_hash(s, mod) == jstable_hash(s, mod)
    assert [tutils.next_pow2(n) for n in range(20)] == \
        [jnext_pow2(n) for n in range(20)]
    x = np.random.default_rng(0).normal(size=(5, 7))
    x[2] = 0.0
    np.testing.assert_array_equal(tutils.l2n(x), jl2n(x))


@pytest.mark.parametrize("index", ["both", "img", "txt"])
def test_standalone_search_matches_jax(index):
    tdbs, rng = _mixed_fleet(VectorDB, 0)
    jdbs, _ = _mixed_fleet(JVectorDB, 0)
    Q = _unit(rng, 5, 24)
    for t, j in zip(tdbs, jdbs):
        _assert_rows_equal(t.search_batch(Q, 8, index=index),
                           j.search_batch(Q, 8, index=index))
        _assert_rows_equal([t.search(Q[0], 5, index=index)],
                           [j.search(Q[0], 5, index=index)])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("index", ["both", "img", "txt"])
def test_masked_scan_matches_oracle_and_jax(index, use_pallas):
    tdbs, rng = _mixed_fleet(VectorDB, 1)
    jdbs, _ = _mixed_fleet(JVectorDB, 1)
    Q = _unit(rng, 7, 24)
    node_ids = [0, 1, 2, 3, 3, 1, 2]
    oracle = [tdbs[n].search_batch(q[None], 8, index=index)[0]
              for q, n in zip(Q, node_ids)]
    ci = ClusterIndex.from_dbs(tdbs, use_pallas=use_pallas, device="cpu")
    got = ci.search_batch(Q, node_ids, 8, index=index)
    _assert_rows_equal(got, oracle)
    want = JClusterIndex.from_dbs(jdbs).search_batch(Q, node_ids, 8,
                                                     index=index)
    _assert_rows_equal(got, want)
    assert ci.stats == {"slab_uploads": 1, "row_updates": 0,
                        "fused_scans": 1, "allgather_bytes": 0}


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("index", ["both", "img", "txt"])
def test_pernode_scan_matches_oracle_and_jax(index, use_pallas):
    tdbs, rng = _mixed_fleet(VectorDB, 2)
    jdbs, _ = _mixed_fleet(JVectorDB, 2)
    Q = _unit(rng, 5, 24)
    oracle = [[db.search_batch(q[None], 6, index=index)[0] for db in tdbs]
              for q in Q]
    ci = ClusterIndex.from_dbs(tdbs, use_pallas=use_pallas, device="cpu")
    rows = ci.search_cluster_nodes(Q, 6, index=index)
    want = JClusterIndex.from_dbs(jdbs).search_cluster_nodes(Q, 6,
                                                             index=index)
    for q_rows, q_oracle, q_want in zip(rows, oracle, want):
        assert len(q_rows) == len(tdbs)
        _assert_rows_equal(q_rows, q_oracle)
        _assert_rows_equal(q_rows, q_want)
    assert ci.stats["fused_scans"] == 1          # one launch for all nodes


def test_cluster_scan_matches_jax():
    tdbs, rng = _mixed_fleet(VectorDB, 3)
    jdbs, _ = _mixed_fleet(JVectorDB, 3)
    Q = _unit(rng, 3, 24)
    ci = ClusterIndex.from_dbs(tdbs, device="cpu")
    got = ci.search_cluster(Q, 5)
    _assert_rows_equal(got, JClusterIndex.from_dbs(jdbs).search_cluster(Q, 5))
    for _, gslots in got:
        assert ((gslots // ci.capacity) < ci.n_nodes).all()


def test_empty_node_returns_no_candidates():
    tdbs, rng = _mixed_fleet(VectorDB, 4)
    ci = ClusterIndex.from_dbs(tdbs, device="cpu")
    (scores, slots), = ci.search_batch(_unit(rng, 1, 24), [0], 4)
    assert len(scores) == 0 and len(slots) == 0


def test_attached_vdb_search_delegates_with_identical_results():
    tdbs, rng = _mixed_fleet(VectorDB, 5)
    q = _unit(rng, 1, 24)[0]
    legacy = [db.search(q, k=5) for db in tdbs]
    ci = ClusterIndex.from_dbs(tdbs, device="cpu")
    qc0 = [db.query_count for db in tdbs]
    for db, want in zip(tdbs, legacy):
        _assert_rows_equal([db.search(q, k=5)], [want])
    assert [db.query_count for db in tdbs] == [c + 1 for c in qc0]
    assert ci.stats["fused_scans"] == len(tdbs)


def test_incremental_state_matches_rebuild_and_jax():
    """Random add/overwrite/evict sequences: the in-place device rows
    equal the rebuilt-from-numpy state and the JAX index's device state,
    with no slab upload after the build."""
    rng_t, rng_j = np.random.default_rng(11), np.random.default_rng(11)
    dim = 12
    tdbs = [VectorDB(dim, c, device="cpu") for c in (8, 16, 16)]
    jdbs = [JVectorDB(dim, c) for c in (8, 16, 16)]
    ci = ClusterIndex.from_dbs(tdbs, device="cpu")
    ji = JClusterIndex.from_dbs(jdbs)
    for dbs, rng in ((tdbs, rng_t), (jdbs, rng_j)):
        for step in range(60):
            db = dbs[int(rng.integers(0, len(dbs)))]
            if rng.integers(0, 3) < 2:
                n = int(rng.integers(1, db.capacity + 3))
                db.add(_unit(rng, n, dim), _unit(rng, n, dim),
                       np.arange(n) + step * 1000, t=float(step))
            else:
                live = np.flatnonzero(db.valid)
                if len(live):
                    db.evict_slots(rng.choice(
                        live, size=int(rng.integers(1, len(live) + 1)),
                        replace=False))
    dev_slabs, dev_valid = ci.device_state()
    ref_slabs, ref_valid = ci.rebuild_reference()
    np.testing.assert_array_equal(dev_valid, ref_valid)
    np.testing.assert_array_equal(dev_slabs, ref_slabs)
    j_slabs, j_valid = ji.device_state()
    np.testing.assert_array_equal(dev_valid, j_valid)
    np.testing.assert_array_equal(dev_slabs, j_slabs)
    assert ci.stats["slab_uploads"] == ji.stats["slab_uploads"] == 1
    assert ci.stats["row_updates"] == ji.stats["row_updates"] > 0


def test_refresh_node_rebinds_restored_vdb():
    rng = np.random.default_rng(13)
    dbs = [VectorDB(8, 8, device="cpu") for _ in range(2)]
    dbs[0].add(_unit(rng, 4, 8), _unit(rng, 4, 8), np.arange(4), 0.0)
    snap = dbs[0].snapshot()
    ci = ClusterIndex.from_dbs(dbs, device="cpu")
    dbs[0].evict_slots(np.array([0, 1, 2, 3]))
    restored = VectorDB.restore(8, 8, snap, device="cpu")
    ci.refresh_node(0, db=restored)
    assert ci.dbs[0] is restored and ci.stats["slab_uploads"] == 2
    restored.add(_unit(rng, 1, 8), _unit(rng, 1, 8), np.array([99]), 1.0)
    for dev, ref in zip(ci.device_state(), ci.rebuild_reference()):
        np.testing.assert_array_equal(dev, ref)


@pytest.mark.parametrize("n", [240, 600])
def test_storage_classifier_assignments_match_jax(n):
    images, captions, _ = make_corpus(n, res=32, seed=0)
    emb = ProxyClipEmbedder(render_caption)
    img_vecs = emb.embed_image(images)
    txt_vecs = emb.embed_text(captions)
    tc = StorageClassifier(4, device="cpu")
    jc = JClassifier(4)
    np.testing.assert_array_equal(tc.fit(img_vecs, txt_vecs),
                                  jc.fit(img_vecs, txt_vecs))
    np.testing.assert_allclose(tc.centroids, jc.centroids, rtol=1e-5,
                               atol=1e-6)
    assert tc.modal_consistency == jc.modal_consistency
    np.testing.assert_array_equal(tc.assign(txt_vecs), jc.assign(txt_vecs))
    payloads = np.arange(n)
    tdbs = tc.build_node_dbs(img_vecs, txt_vecs, payloads,
                             capacity_per_node=n)
    jdbs = jc.build_node_dbs(img_vecs, txt_vecs, payloads,
                             capacity_per_node=n)
    for t, j in zip(tdbs, jdbs):
        np.testing.assert_array_equal(t.payload_ids, j.payload_ids)
        np.testing.assert_array_equal(t.valid, j.valid)
        assert t.use_pallas and not j.use_pallas   # the port's default


def _prompts(n, seed=0):
    return [r.prompt for r in RequestTrace(seed=seed).generate(n)]


def test_score_mode_is_one_scan_per_microbatch_with_zero_uploads():
    system, _, _, _ = build_system(n_nodes=3, corpus_n=90,
                                   capacity_per_node=60, device="cpu")
    ci = system.cluster_index
    assert system.routing == "score"
    prompts = _prompts(24, seed=3)
    system.serve_batch(prompts[:8], seeds=list(range(8)))      # warmup
    uploads, scans = ci.stats["slab_uploads"], ci.stats["fused_scans"]
    for lo in (8, 16):
        system.serve_batch(prompts[lo:lo + 8], seeds=list(range(lo, lo + 8)))
    assert ci.stats["slab_uploads"] == uploads   # ZERO steady-state uploads
    assert ci.stats["fused_scans"] == scans + 2  # one per micro-batch
    assert ci.stats["row_updates"] > 0           # archives flowed as rows


def test_centroid_mode_retrieve_is_one_masked_scan(monkeypatch):
    system, _, _, _ = build_system(n_nodes=3, corpus_n=90,
                                   capacity_per_node=60, routing="centroid",
                                   device="cpu")
    ci = system.cluster_index
    calls = []
    orig = ci.search_batch
    monkeypatch.setattr(ci, "search_batch",
                        lambda *a, **kw: calls.append(a) or orig(*a, **kw))
    monkeypatch.setattr(
        VectorDB, "search_batch",
        lambda self, *a, **kw: pytest.fail("per-node search on serve path"))
    assert len(system.serve_batch(_prompts(8), seeds=list(range(8)))) == 8
    assert len(calls) == 1
