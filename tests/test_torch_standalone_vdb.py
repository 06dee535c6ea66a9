"""The single-slab scan (K3) and the standalone ``VectorDB`` that runs it,
the port against the JAX package, on the CPU.

* ``vdb_topk_ref`` (what ``ops.vdb_topk`` runs on a CPU tensor) against
  the Pallas kernel ``vdb_topk(interpret=True)``: exact ties, masked rows,
  an empty db, k equal to the db's size.  Slots are equal wherever a
  candidate is valid; masked candidates are ``-inf`` in the port and the
  ``-1e30`` sentinel in JAX, and both are dropped by the host.
* A standalone ``VectorDB(device="cpu")`` against the JAX
  ``VectorDB(use_pallas=True, interpret=True)``: equal slots.
* A fleet without a cluster index (``use_cluster_index=False``, the
  paper's one-pgvector-per-node design) drained through the NullBackend:
  routes, nodes, images and cache state equal JAX's.

Scores agree to 1e-5 (two frameworks' f32 dot products)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.system import CacheGenius as JCacheGenius
from repro.core.trace import RequestTrace
from repro.core.vdb import VectorDB as JVectorDB
from repro.kernels.vdb_topk import vdb_topk as jvdb_topk
from repro.launch.serve import build_system as jbuild
from repro.runtime.serving import ServingEngine as JEngine
from repro_torch.core.system import CacheGenius
from repro_torch.kernels import ops, ref
from repro_torch.kernels import vdb_topk as tscan
from repro_torch.core.vdb import VectorDB
from repro_torch.launch.serve import build_system
from repro_torch.runtime.serving import ServingEngine

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _case(kind: str, n: int = 40, d: int = 16, q: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "ties":      # integer rows, repeated: exact equal scores
        db = rng.integers(-1, 2, size=(n, d)).astype(np.float32)
        db[n // 2:] = db[: n - n // 2]
        qs = rng.integers(-1, 2, size=(q, d)).astype(np.float32)
    else:
        db = rng.normal(size=(n, d)).astype(np.float32)
        qs = rng.normal(size=(q, d)).astype(np.float32)
    valid = rng.random(n) < 0.6
    if kind == "empty":
        valid[:] = False
    return qs, db, valid


@pytest.mark.parametrize("kind,k", [("random", 8), ("ties", 8),
                                    ("empty", 8), ("random", 40)])
def test_vdb_topk_ref_matches_pallas(kind, k):
    qs, db, valid = _case(kind)
    j_s, j_i = (np.asarray(a) for a in jvdb_topk(
        jnp.asarray(qs), jnp.asarray(db), jnp.asarray(valid), k,
        interpret=True))
    args = [torch.from_numpy(a) for a in (qs, db, valid)]
    t_s, t_i = ref.vdb_topk_ref(*args, k)
    live = j_s > -1e29
    assert np.array_equal(live, np.isfinite(t_s.numpy()))
    assert live.sum() == min(k, int(valid.sum())) * len(qs)
    np.testing.assert_array_equal(t_i.numpy()[live], j_i[live])
    np.testing.assert_allclose(t_s.numpy()[live], j_s[live], **SCORE_TOL)
    o_s, o_i = ops.vdb_topk(*args, k)           # CPU dispatch -> plain
    assert torch.equal(o_s, t_s) and torch.equal(o_i, t_i)


def test_single_scan_wrapper_refuses_what_the_kernel_cannot_take():
    qs, db, valid = (torch.from_numpy(a) for a in _case("random"))
    with pytest.raises(ValueError, match="CUDA"):
        tscan.launch_single(qs, db, valid, 8)
    with pytest.raises(ValueError, match="expected db"):
        tscan.launch_single(qs, db[None], valid, 8)


def _fill(db, rng, n, dim, t=0.0):
    v = rng.normal(size=(2, n, dim)).astype(np.float32)
    db.add(v[0], v[1], np.arange(n) + int(t) * 100, t)


@pytest.mark.parametrize("index", ["both", "img", "txt"])
@pytest.mark.parametrize("fill", [0, 11, 30, 45])
def test_standalone_vectordb_matches_jax_pallas(index, fill):
    """Empty, partial, full and overwritten (FIFO) dbs; search and
    search_batch, with exactly equal slots."""
    dim, cap = 16, 30
    tdb = VectorDB(dim, cap, device="cpu")
    jdb = JVectorDB(dim, cap, use_pallas=True, interpret=True)
    for db in (tdb, jdb):
        rng = np.random.default_rng(fill)
        if fill:
            _fill(db, rng, fill, dim)
            db.evict_slots(np.array([0, 3]))
    qs = np.random.default_rng(99).normal(size=(3, dim)).astype(np.float32)
    for k in (5, cap):
        got = tdb.search_batch(qs, k, index=index)
        want = jdb.search_batch(qs, k, index=index)
        got.append(tdb.search(qs[0], k, index=index))
        want.append(jdb.search(qs[0], k, index=index))
        for (g_s, g_l), (w_s, w_l) in zip(got, want):
            np.testing.assert_array_equal(g_l, w_l)
            np.testing.assert_allclose(g_s, w_s, **SCORE_TOL)
    assert tdb.query_count == jdb.query_count


def _standalone(build, cls, **kw):
    """``build_system``'s fleet reassembled as a CacheGenius without a
    cluster index: each node's db searches on its own."""
    system, _, _, _ = build(n_nodes=4, corpus_n=120, capacity_per_node=80,
                            seed=0, **kw)
    for db in system.dbs:
        db.unregister_cluster(system.cluster_index)
    return cls(embedder=system.embedder, dbs=system.dbs,
               blob_store=system.blob_store, backend=system.backend,
               classifier=system.classifier, policy=system.policy,
               latency_model=system.latency_model,
               cost_model=system.cost_model, eviction=system.eviction,
               node_speeds=[n.speed for n in system.scheduler.nodes],
               use_cluster_index=False)


def test_standalone_fleet_drain_equals_jax():
    tsys = _standalone(build_system, CacheGenius, device="cpu")
    jsys = _standalone(jbuild, JCacheGenius)
    assert tsys.cluster_index is None and jsys.cluster_index is None
    reqs = list(RequestTrace(seed=1).generate(40))
    done = {}
    for name, system, engine_cls in (("port", tsys, ServingEngine),
                                     ("jax", jsys, JEngine)):
        engine = engine_cls(system, max_batch=8)
        for i, r in enumerate(reqs):
            engine.submit(r.prompt, seed=i, quality_tier=r.quality_tier)
        done[name] = engine.drain()
    assert [c.result.route.name for c in done["port"]] == \
        [c.result.route.name for c in done["jax"]]
    assert [c.result.node for c in done["port"]] == \
        [c.result.node for c in done["jax"]]
    for a, b in zip(done["port"], done["jax"]):
        np.testing.assert_array_equal(np.asarray(a.result.image),
                                      np.asarray(b.result.image))
    for t, j in zip(tsys.dbs, jsys.dbs):
        np.testing.assert_array_equal(t.valid, j.valid)
        np.testing.assert_array_equal(t.payload_ids, j.payload_ids)
        assert t.query_count == j.query_count > 0
    assert tsys.stats.route_counts == jsys.stats.route_counts
