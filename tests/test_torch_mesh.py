"""The port's node mesh (the sharded cluster index) against the JAX
package's, on the CPU.

The JAX side runs on the conftest's forced host devices (the
``mesh_devices`` fixture); the port's shards all live on ``cpu``, so its
scans take the plain versions, shard by shard.  The same numpy inputs go
through both:

* the mesh scans (``vdb_topk_sharded_mesh``, node-masked and global, and
  ``vdb_topk_pernode_mesh``) and the host merge (``merge_shard_topk``)
  against the JAX functions;
* ``ClusterIndex(mesh_nodes=m)``'s three searches against JAX's;
* a stream of adds and evicts, and an end-to-end serve across a crash, a
  rejoin and a join, against the port's and JAX's ``mesh_nodes=1`` (the
  reference's own mesh fails its row updates under the installed JAX,
  and its contract is bitwise equality with ``mesh_nodes=1``).

Slot ids and discrete state must be equal; f32 scores agree to 2e-5
(``tests/test_kernels.py``'s tolerance)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.cluster_index import ClusterIndex as JClusterIndex
from repro.core.trace import RequestTrace
from repro.core.vdb import VectorDB as JVectorDB
from repro.kernels import vdb_topk as jvdb
from repro.launch.mesh import make_node_mesh as jmake_node_mesh
from repro.launch.serve import build_system as jbuild
from repro.runtime.serving import ServingEngine as JEngine
from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.vdb import VectorDB
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import NodeMesh, make_node_mesh
from repro_torch.runtime import partition
from repro_torch.runtime.serving import ServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)
DIM = 16
# (nodes, mesh): an even split, padding with a shard of pad nodes only,
# a shard holding a real node and a pad node, one node over two shards
MESH_CASES = [(4, 2), (4, 3), (5, 3), (7, 4), (1, 2)]


def _unit(rng, n, d=DIM):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _slab_inputs(seed, n_nodes, mesh, cap=12, qn=5):
    """Padded (2, nodes, cap, D) slabs and validity (pad nodes invalid),
    queries and node ids, from one seed."""
    rng = np.random.default_rng(seed)
    padded = partition.padded_nodes(n_nodes, mesh)
    slabs = np.zeros((2, padded, cap, DIM), np.float32)
    slabs[:, :n_nodes] = _unit(rng, 2 * n_nodes * cap).reshape(
        2, n_nodes, cap, DIM)
    valid = np.zeros((padded, cap), bool)
    valid[:n_nodes] = rng.random((n_nodes, cap)) < 0.6
    return slabs, valid, _unit(rng, qn), rng.integers(0, n_nodes, qn)


def _port_shards(slabs, valid, mesh):
    n = slabs.shape[1] // mesh
    return [(torch.from_numpy(slabs[:, s * n:(s + 1) * n].copy()),
             torch.from_numpy(valid[s * n:(s + 1) * n].copy()))
            for s in range(mesh)]


def _assert_lists(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("n_nodes,mesh", MESH_CASES)
@pytest.mark.parametrize("mask_nodes", [True, False])
def test_sharded_mesh_scan_matches_jax(n_nodes, mesh, mask_nodes,
                                       mesh_devices):
    slabs, valid, q, nids = _slab_inputs(n_nodes * 10 + mesh, n_nodes, mesh)
    k = 5 if mask_nodes else 7
    got = ops.vdb_topk_sharded_mesh(torch.from_numpy(q),
                                    _port_shards(slabs, valid, mesh), nids,
                                    k, mask_nodes=mask_nodes)
    want = jvdb.vdb_topk_sharded_mesh(
        q, slabs, valid, nids.astype(np.int32), k,
        mesh=jmake_node_mesh(mesh), mask_nodes=mask_nodes)
    assert got[0].shape == (mesh, 2, len(q), k)
    _assert_lists(got, want)
    _assert_lists(ops.merge_shard_topk(*got, k),
                  jvdb.merge_shard_topk(np.asarray(want[0]),
                                        np.asarray(want[1]), k))


@pytest.mark.parametrize("n_nodes,mesh", MESH_CASES)
def test_pernode_mesh_scan_matches_jax(n_nodes, mesh, mesh_devices):
    slabs, valid, q, _ = _slab_inputs(n_nodes * 7 + mesh, n_nodes, mesh)
    got = ops.vdb_topk_pernode_mesh(torch.from_numpy(q),
                                    _port_shards(slabs, valid, mesh), 4)
    want = jvdb.vdb_topk_pernode_mesh(q, slabs, valid, 4,
                                      mesh=jmake_node_mesh(mesh))
    assert got[0].shape == (2, slabs.shape[1], len(q), 4)
    _assert_lists(got, want)


@pytest.mark.parametrize("sentinel", [-np.inf, -1e30])
def test_merge_keeps_the_one_device_order_across_shards(sentinel):
    """Integer scores tie across every shard boundary; masked candidates
    carry either sentinel (the plain versions' -inf, the kernels'
    -1e30).  The merge orders by score, then global slot, as JAX's."""
    rng = np.random.default_rng(3)
    shards, n_idx, qn, kl = 3, 2, 4, 6
    scores = rng.integers(-2, 3, (shards, n_idx, qn, kl)).astype(np.float32)
    scores[:, :, :, -2:] = sentinel
    ids = np.stack([rng.permutation(60)[:n_idx * qn * kl].reshape(
        n_idx, qn, kl) + 60 * s for s in range(shards)]).astype(np.int32)
    # each shard's list sorted as a scan gives it
    order = np.lexsort((ids, -scores), axis=-1)
    scores = np.take_along_axis(scores, order, -1)
    ids = np.take_along_axis(ids, order, -1)
    for k in (1, 5, 18, 30):
        got = ops.merge_shard_topk(scores, ids, k)
        want = jvdb.merge_shard_topk(scores, ids, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    s, i = ops.merge_shard_topk(scores, ids, 18)
    tie = s[..., :-1] == s[..., 1:]
    assert tie.any() and (i[..., :-1][tie] < i[..., 1:][tie]).all()


def _fleet(cls, seed, n_nodes, dim=DIM):
    """Empty, partial, full and overfull (FIFO wrap) nodes, capacities
    8-24, built alike for either package's VectorDB."""
    rng = np.random.default_rng(seed)
    kw = dict(device="cpu") if cls is VectorDB else {}
    dbs = []
    for ni in range(n_nodes):
        cap = int(rng.choice([8, 12, 16, 24]))
        db = cls(dim, cap, name=f"n{ni}", **kw)
        fill = (0, cap // 2, cap, cap + cap // 2)[(ni + seed) % 4]
        if fill:
            db.add(_unit(rng, fill, dim), _unit(rng, fill, dim),
                   np.arange(fill), float(ni))
        dbs.append(db)
    return dbs


def _assert_rows(got, want):
    assert len(got) == len(want)
    for (g_s, g_l), (w_s, w_l) in zip(got, want):
        np.testing.assert_array_equal(g_l, np.asarray(w_l))
        np.testing.assert_allclose(g_s, np.asarray(w_s), **TOL)


@pytest.mark.parametrize("n_nodes,mesh", [(4, 2), (5, 3), (7, 4)])
def test_cluster_index_searches_match_jax_mesh(n_nodes, mesh,
                                               mesh_devices):
    ci = ClusterIndex.from_dbs(_fleet(VectorDB, n_nodes, n_nodes),
                               mesh_nodes=mesh, device="cpu")
    ji = JClusterIndex.from_dbs(_fleet(JVectorDB, n_nodes, n_nodes),
                                mesh_nodes=mesh)
    assert ci.padded_nodes == ji.padded_nodes
    rng = np.random.default_rng(n_nodes)
    Q = _unit(rng, 5)
    nids = rng.integers(0, n_nodes, 5)
    for index in ("both", "img", "txt"):
        _assert_rows(ci.search_cluster(Q, 9, index=index),
                     ji.search_cluster(Q, 9, index=index))
        _assert_rows(ci.search_batch(Q, nids, 6, index=index),
                     ji.search_batch(Q, nids, 6, index=index))
        for g, w in zip(ci.search_cluster_nodes(Q, 5, index=index),
                        ji.search_cluster_nodes(Q, 5, index=index)):
            _assert_rows(g, w)
    assert ci.stats["fused_scans"] == ji.stats["fused_scans"] == 9
    np.testing.assert_array_equal(ci.node_vectors(), ji.node_vectors())


@pytest.mark.parametrize("n_nodes,mesh,seed", [(5, 3, 0), (7, 4, 1),
                                               (3, 2, 2)])
def test_incremental_stream_on_a_mesh_matches_mesh_1_and_jax(n_nodes, mesh,
                                                             seed):
    """A seeded stream of adds (FIFO overwrites included) and evicts
    through three fleets: the port's mesh index, the port's mesh-1 index
    and JAX's mesh-1 index.  The mesh's device state equals its rebuild
    from the numpy views, with no slab upload after the build, and its
    scans equal both mesh-1 indexes'."""
    fleets = [_fleet(VectorDB, seed, n_nodes),
              _fleet(VectorDB, seed, n_nodes),
              _fleet(JVectorDB, seed, n_nodes)]
    cm = ClusterIndex.from_dbs(fleets[0], mesh_nodes=mesh, device="cpu")
    c1 = ClusterIndex.from_dbs(fleets[1], device="cpu")
    j1 = JClusterIndex.from_dbs(fleets[2])
    rng = np.random.default_rng(100 + seed)
    for step in range(40):
        node = int(rng.integers(0, n_nodes))
        if rng.random() < 0.3 and fleets[0][node].size > 0:
            slots = rng.choice(fleets[0][node].capacity, 2, replace=False)
            for f in fleets:
                f[node].evict_slots(slots)
        else:
            n = int(rng.integers(1, 4))
            img, txt = _unit(rng, n), _unit(rng, n)
            for f in fleets:
                f[node].add(img, txt, np.arange(n) + 1000 + 10 * step,
                            float(step))
    assert cm.stats["slab_uploads"] == 1
    assert cm.stats["row_updates"] == c1.stats["row_updates"] > 0
    for got, want in zip(cm.device_state(), cm.rebuild_reference()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(cm.device_state(), c1.device_state()):
        np.testing.assert_array_equal(got, want)
    Q = _unit(rng, 6)
    nids = rng.integers(0, n_nodes, 6)
    for other in (c1, j1):
        _assert_rows(cm.search_cluster(Q, 7), other.search_cluster(Q, 7))
        _assert_rows(cm.search_batch(Q, nids, 5, count_queries=False),
                     other.search_batch(Q, nids, 5, count_queries=False))
        for g, w in zip(cm.search_cluster_nodes(Q, 4),
                        other.search_cluster_nodes(Q, 4)):
            _assert_rows(g, w)
    # a restored db rebinds to its node's shard
    node = n_nodes - 1
    snap = fleets[0][node].snapshot()
    fleets[0][node].evict_slots(np.arange(fleets[0][node].capacity))
    restored = VectorDB.restore(DIM, fleets[0][node].capacity, snap,
                                device="cpu")
    cm.refresh_node(node, db=restored)
    assert cm.stats["slab_uploads"] == 2
    for got, want in zip(cm.device_state(), cm.rebuild_reference()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_nodes,mesh,padded", [
    (1, 2, 2), (3, 2, 4), (4, 2, 4), (4, 3, 6), (5, 3, 6), (7, 4, 8),
    (0, 3, 3)])
def test_padding_rule_matches_jax(n_nodes, mesh, padded, mesh_devices):
    assert partition.padded_nodes(n_nodes, mesh) == padded
    assert partition.padded_nodes(n_nodes, 1) == n_nodes
    if n_nodes == 0:
        return
    ci = ClusterIndex.from_dbs(_fleet(VectorDB, 0, n_nodes),
                               mesh_nodes=mesh, device="cpu")
    ji = JClusterIndex.from_dbs(_fleet(JVectorDB, 0, n_nodes),
                                mesh_nodes=mesh)
    assert ci.padded_nodes == ji.padded_nodes == padded
    assert len(ci.shards) == mesh and ci.n_shard == padded // mesh
    # pad nodes stay invalid and the public state cuts them off
    valid = torch.cat([v for _, v in ci.shards])
    assert not valid[n_nodes:].any()
    slabs, val = ci.device_state()
    assert slabs.shape[1] == val.shape[0] == n_nodes
    # one shard's bytes are JAX's bytes per device
    shard_bytes = sum(t.numel() * t.element_size() for t in ci.shards[0])
    assert shard_bytes == ji.per_device_slab_bytes()


def test_per_device_bytes_count_every_shard_a_device_holds():
    dbs = _fleet(VectorDB, 1, 8)
    one = ClusterIndex.from_dbs(dbs, device="cpu")
    for d in dbs:
        d.unregister_cluster(one)
    mesh = ClusterIndex.from_dbs(dbs, mesh_nodes=4, device="cpu")
    shard = sum(t.numel() * t.element_size() for t in mesh.shards[0])
    assert shard * 4 == one.per_device_slab_bytes()
    # four CPU shards: the one device holds all of them
    assert mesh.per_device_slab_bytes() == 4 * shard
    spread = partition.device_bytes(
        [torch.zeros(3, device="meta"), torch.zeros(2, dtype=torch.int64),
         torch.zeros(5, dtype=torch.bool)])
    assert spread == {torch.device("meta"): 12, torch.device("cpu"): 21}


def test_allgather_bytes_count_the_lists_brought_back():
    n_nodes, mesh, qn = 5, 3, 6
    ci = ClusterIndex.from_dbs(_fleet(VectorDB, 2, n_nodes),
                               mesh_nodes=mesh, device="cpu")
    q = _unit(np.random.default_rng(0), qn)
    ci.search_cluster(q, 9)
    k_local = min(9, ci.n_shard * ci.capacity)
    assert ci.stats["allgather_bytes"] == mesh * 2 * qn * k_local * 8
    ci.search_cluster_nodes(q, 4, index="img")
    assert ci.stats["allgather_bytes"] == (
        mesh * 2 * qn * k_local * 8 + 1 * ci.padded_nodes * qn * 4 * 8)
    one = ClusterIndex.from_dbs(_fleet(VectorDB, 2, n_nodes), device="cpu")
    one.search_cluster(q, 9)
    assert one.stats["allgather_bytes"] == 0


def test_make_node_mesh_raises_where_it_should():
    for bad in (0, -1):
        with pytest.raises(ValueError, match="mesh_nodes must be >= 1"):
            make_node_mesh(bad, "cpu")
    with pytest.raises(ValueError, match="needs as many devices"):
        make_node_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="no node mesh"):
        make_node_mesh(2, "meta")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="needs that many cards"):
        make_node_mesh(n + 1, "cuda")
    m = make_node_mesh(3, "cpu")
    assert m == NodeMesh((torch.device("cpu"),) * 3)
    assert m.shape == {"nodes": 3}
    m = make_node_mesh(2, devices=["cuda:0", "cuda:0"])
    assert m.devices == (torch.device("cuda", 0),) * 2
    with pytest.raises(ValueError, match="mesh_nodes must be >= 1"):
        ClusterIndex(8, [4, 4], mesh_nodes=0, device="cpu")


def _serve_phases(build, engine_cls, **kw):
    """Drain 16 requests; crash node 3, drain 8; rejoin it, join a fifth
    node, drain 16 — routes, nodes and images of each request, and the
    final cache state."""
    system, _, _, _ = build(n_nodes=4, corpus_n=120, capacity_per_node=80,
                            seed=0, **kw)
    engine = engine_cls(system, max_batch=8)
    reqs = list(RequestTrace(seed=1).generate(40))
    done = []

    def drain(lo, hi):
        for i in range(lo, hi):
            engine.submit(reqs[i].prompt, seed=i,
                          quality_tier=reqs[i].quality_tier)
        done.extend(engine.drain())

    drain(0, 16)
    system.crash_node(3)
    drain(16, 24)
    system.rejoin_node(3)
    assert system.join_node() == 4
    drain(24, 40)
    return dict(
        routes=[c.result.route.name for c in done],
        nodes=[c.result.node for c in done],
        images=[np.asarray(c.result.image) for c in done],
        state=[(db.valid.copy(), db.img_vecs.copy(), db.payload_ids.copy())
               for db in system.dbs],
        system=system)


def test_mesh_serve_equals_mesh_1_and_jax_across_crash_rejoin_join():
    got = _serve_phases(tserve.build_system, ServingEngine, mesh_nodes=3,
                        device="cpu")
    for want in (_serve_phases(tserve.build_system, ServingEngine,
                               device="cpu"),
                 _serve_phases(jbuild, JEngine)):
        assert got["routes"] == want["routes"]
        assert got["nodes"] == want["nodes"]
        for a, b in zip(got["images"], want["images"]):
            np.testing.assert_array_equal(a, b)
        assert len(got["state"]) == len(want["state"]) == 5
        for a, b in zip(got["state"], want["state"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert (got["system"].cluster_index.stats["fused_scans"]
                == want["system"].cluster_index.stats["fused_scans"])
    ci = got["system"].cluster_index
    # the join re-stacked 5 nodes onto the same 3 shards: padded to 6
    assert (ci.mesh_nodes, ci.n_nodes, ci.padded_nodes) == (3, 5, 6)
    assert ci.mesh == got["system"].mesh
    assert ci.stats["allgather_bytes"] > 0
    for a, b in zip(ci.device_state(), ci.rebuild_reference()):
        np.testing.assert_array_equal(a, b)


def test_serve_cli_runs_a_cpu_mesh(capsys):
    argv = ["--requests", "16", "--nodes", "3", "--device", "cpu"]
    assert tserve.main(argv) == 0
    one = capsys.readouterr().out
    assert tserve.main(argv + ["--mesh-nodes", "2"]) == 0
    two = capsys.readouterr().out

    def line(out, key):
        return next(ln for ln in out.splitlines() if ln.startswith(key))

    assert line(two, "route mix") == line(one, "route mix")
    assert line(two, "hit rate") == line(one, "hit rate")
    assert "cluster mesh       : 2 shards on cpu, cpu (3 nodes padded " \
           "to 4)" in two
    assert "cluster mesh" not in one


def test_serve_cli_refuses_a_mesh_of_more_cards_than_it_sees(capsys):
    n = torch.cuda.device_count()
    m = max(n + 1, 2)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cuda", "--mesh-nodes", str(m)])
    assert exc.value.code == 2
    assert f"--mesh-nodes {m} needs that many cards, the process " \
           f"sees {n}" in capsys.readouterr().err
