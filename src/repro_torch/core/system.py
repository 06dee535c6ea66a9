"""CacheGenius orchestrator — one staged, batch-first request path (Fig. 5).

The port of the JAX package's ``repro/core/system.py``: the orchestrator
is the same host code; its cluster index lives on ``device`` (the card
by default) and scans through the CUDA kernels.  ``mesh_nodes > 1``
shards the index over a node mesh (``mesh_devices``, or one card per
shard), kept across every restack.

Every request — sequential or batched — flows through the SAME explicit
pipeline (``repro_torch.core.pipeline.ServePipeline``):

    Embed -> Schedule -> Retrieve -> Score -> Plan -> Generate
          -> Archive -> Finish

``serve`` is a batch of one; ``serve_batch`` is the same pipeline over a
micro-batch, so sequential/batched parity holds by construction.  Per
request the pipeline carries a typed ``RequestState``:

    index, raw_prompt, prompt (optimised), seed, quality_tier, clock,
    pkey, pvec/qvec (text embedding), decision (ScheduleDecision),
    ret_scores/ret_slots (dual-retrieval rows), best_slot/best_score,
    plan (typed Plan: alias | history | cached | gen), image, result.

Stage map onto the paper: Embed = prompt-optimizer + embedding-generator
(§IV-B/C), Schedule = request scheduler with history/priority fast paths
(§IV-E), Retrieve+Score+Plan = dual ANN retrieval and Algorithm 1 routing
(Eq. 7), Generate = {cached | SDEdit img2img K steps | txt2img N steps},
Archive = blob store + VDB insert, Finish = Eq. 8 latency/cost accounting
and the periodic LCU sweep (Algorithm 2).

Retrieval engine: construction builds a
``repro_torch.core.cluster_index.ClusterIndex`` over the node fleet — the
cluster's cache state lives device-resident as stacked
``(2, nodes, capacity, dim)`` img/txt slabs updated incrementally by
every VDB ``add``/``evict`` (one build-time upload, zero steady-state
slab copies), and the Retrieve stage answers each micro-batch with ONE
fused masked scan across all touched nodes (``use_cluster_index=False``
restores the per-node loop).

Score-aware scheduling: with ``routing="score"`` (the default
when a cluster index exists) the Schedule stage issues the micro-batch's
single cluster-wide scan (``ClusterIndex.search_cluster_nodes``) so
every request is routed on its TRUE best composite (Eq. 7) match on
every node — blended with the centroid-affinity prior, queue-depth load
penalty and the Eq. 8 expected-latency term — and the chosen node's
candidate rows are reused by the Retrieve stage (Schedule+Retrieve = ONE
device scan per micro-batch).  ``routing="centroid"`` keeps the paper's
Eq. 6 node-representation baseline, which also remains the automatic
fallback when no cluster index is attached.

Latent-depth cache (beyond-paper): with ``latent_depths`` set the
Archive stage stores noised intermediates of each finished image's
img2img chain at depths k ∈ {K/4, K/2, 3K/4} (one stacked ``VectorDB``
insert carrying host-side ``depth``/``source_id`` metadata — device
slabs and fused scans are untouched), and the Plan stage maps the
composite Eq. 7 score to a resume depth (``policy.resume_depth``):
strong band matches resume deep and run only K - k steps through the
backend's ``resume_batch``.  Latents and finished images compete under
the same ``C_max`` via the eviction policy's per-depth utility discount.

Backend protocol migration (for external callers of ``GenerationBackend``):
it is no longer a dataclass of four optional callables but a batch-first
base class — subclass it and implement ``txt2img_batch`` /
``img2img_batch``; scalar ``txt2img`` / ``img2img`` derive automatically
as a batch of one.  Constructing ``GenerationBackend(txt2img=f, ...)``
with the old callables still works: they are wrapped by the
``CallableBackend`` adapter (missing batch callables fall back to a
per-request loop).  ``DiffusionBackend`` now IS a ``GenerationBackend``;
its ``as_generation_backend()`` survives as a no-op compatibility shim.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.latency_model import CostModel, LatencyModel
from repro_torch.core.lcu import EvictionPolicy, LCUPolicy
from repro_torch.core.pipeline import (CallableBackend, GenerationBackend, Plan,
                                 RequestState, ServePipeline)
from repro_torch.core.policy import GenerationPolicy, Route
from repro_torch.core.prompt_optimizer import PromptOptimizer
from repro_torch.core.scheduler import NodeInfo, RequestScheduler
from repro_torch.core.storage_classifier import StorageClassifier
from repro_torch.core.vdb import BlobStore, VectorDB
from repro_torch.launch.mesh import make_node_mesh

__all__ = ["CacheGenius", "CallableBackend", "GenerationBackend", "Plan",
           "RequestState", "Route", "ServePipeline", "ServeResult",
           "ServeStats"]


@dataclass
class ServeResult:
    image: np.ndarray
    route: Route
    node: int
    score: float
    latency: float            # Eq. 8 modelled latency
    wall_latency: float       # batch-amortised measured wall-clock on this host
    steps: int
    fast_path: Optional[str] = None
    # latent-depth cache: depth the denoising chain resumed from (-1 =
    # classic path, k >= 0 = resumed from an archived depth-k latent and
    # ran only steps = K - k chain steps)
    resumed_from: int = -1
    # true per-request accounting from the pipeline's per-stage timestamps
    # (back-filled by ServePipeline.run; see its timing contract):
    queue_delay: float = 0.0  # submission -> pipeline admission (caller clock)
    wall_total: float = 0.0   # pipeline admission -> Finish, measured
    stage_walls: Dict[str, float] = field(default_factory=dict)
    # degraded mode: the matched reference failed its checksum and the
    # request was served through the full txt2img miss path instead
    degraded: bool = False


@dataclass
class ServeStats:
    route_counts: Dict[str, int] = field(default_factory=dict)
    latencies: List[float] = field(default_factory=list)
    wall_latencies: List[float] = field(default_factory=list)
    # one entry per served micro-batch: that batch's TOTAL wall-clock.
    # Per-request ``wall_latencies`` are batch-amortised (total / batch
    # size), so sum(wall_latencies) ~= sum(batch_wall_latencies).
    batch_wall_latencies: List[float] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    requests: int = 0
    cache_hits: int = 0        # HIT_RETURN + history fast path
    reference_hits: int = 0    # IMG2IMG
    total_steps: int = 0       # denoising steps actually executed
    latent_resumes: int = 0    # requests resumed from an archived latent
    # fault-domain accounting (repro_torch.core.pipeline verified fetches /
    # transient retry; the chaos harness is not ported yet)
    corrupt_hits: int = 0      # checksum-failing blobs caught at hit time
    degraded_serves: int = 0   # requests degraded to the txt2img miss path
    transient_retries: int = 0  # failed backend attempts that were retried

    def record(self, r: ServeResult) -> None:
        self.requests += 1
        key = r.fast_path or r.route.value
        self.route_counts[key] = self.route_counts.get(key, 0) + 1
        self.latencies.append(r.latency)
        self.wall_latencies.append(r.wall_latency)
        self.scores.append(r.score)
        self.total_steps += r.steps
        if r.resumed_from >= 0:
            self.latent_resumes += 1
        if r.degraded:
            self.degraded_serves += 1
        if r.route is Route.HIT_RETURN or r.fast_path == "history":
            self.cache_hits += 1
        elif r.route is Route.IMG2IMG:
            self.reference_hits += 1

    @property
    def hit_rate(self) -> float:
        """Any outcome that avoided full-noise generation counts as a hit."""
        useful = self.cache_hits + self.reference_hits
        return useful / max(self.requests, 1)

    @property
    def mean_steps(self) -> float:
        """Mean denoising steps executed per request — the latent-depth
        cache's headline metric (lower = more work skipped)."""
        return self.total_steps / max(self.requests, 1)


class CacheGenius:
    def __init__(self, *, embedder, dbs: Sequence[VectorDB], blob_store: BlobStore,
                 backend: GenerationBackend,
                 classifier: Optional[StorageClassifier] = None,
                 policy: Optional[GenerationPolicy] = None,
                 latency_model: Optional[LatencyModel] = None,
                 cost_model: Optional[CostModel] = None,
                 eviction: Optional[EvictionPolicy] = None,
                 prompt_optimizer: Optional[PromptOptimizer] = None,
                 node_speeds: Optional[Sequence[float]] = None,
                 cache_capacity: Optional[int] = None,
                 maintenance_interval: int = 200,
                 topk: int = 8,
                 transient_retries: int = 2,
                 use_scheduler: bool = True,
                 use_prompt_optimizer: bool = True,
                 use_cluster_index: bool = True,
                 mesh_nodes: int = 1,
                 routing: str = "score",
                 latent_depths=None,
                 pipeline: Optional[ServePipeline] = None,
                 device="cuda",
                 mesh_devices: Optional[Sequence] = None):
        if routing not in ("score", "centroid"):
            raise ValueError(
                f"routing must be 'score' or 'centroid', got {routing!r}")
        self.embedder = embedder
        self.dbs = list(dbs)
        self.blob_store = blob_store
        self.backend = backend
        self.classifier = classifier
        self.policy = policy or GenerationPolicy()
        self.latency_model = latency_model or LatencyModel()
        self.cost_model = cost_model or CostModel()
        self.eviction = eviction or LCUPolicy()
        self.prompt_optimizer = prompt_optimizer or PromptOptimizer()
        speeds = list(node_speeds or [1.0] * len(self.dbs))
        self.scheduler = RequestScheduler(
            nodes=[NodeInfo(i, speed=s) for i, s in enumerate(speeds)])
        self.cache_capacity = cache_capacity or sum(db.capacity for db in self.dbs)
        self.maintenance_interval = maintenance_interval
        self.topk = topk
        # how many times the Generate stage retries a backend call that
        # raised TransientBackendError before letting it propagate
        self.transient_retries = int(transient_retries)
        self.use_scheduler = use_scheduler
        self.use_prompt_optimizer = use_prompt_optimizer
        # device-resident cross-node retrieval engine: the fleet's cache
        # state lives on device (ONE build-time upload, incremental row
        # updates from every add/evict) and the Schedule/Retrieve stages
        # issue ONE fused scan per micro-batch across all touched nodes.
        # mesh_nodes > 1 shards the slabs over a node mesh, built once
        # here (each shard scans on its own device; results stay bitwise
        # identical) and kept across every re-stack (join/crash/rejoin).
        self.mesh_nodes = int(mesh_nodes)
        self.device = device
        self.mesh = (make_node_mesh(self.mesh_nodes, device,
                                    devices=mesh_devices)
                     if self.mesh_nodes > 1 else None)
        self.cluster_index = (self._build_cluster_index()
                              if use_cluster_index and self.dbs else None)
        # routing="score" (default): the Schedule stage routes on each
        # request's TRUE best composite match per node from the cluster
        # scan, blended with load + expected latency; "centroid" is the
        # Eq. 6 baseline and the automatic no-cluster-index fallback.
        self.routing = routing
        # latent-depth cache: archive noised img2img intermediates at these
        # chain depths alongside each finished image and let the Plan stage
        # resume denoising from them.  None/() = off (classic binary
        # split); True = the policy's default {K/4, K/2, 3K/4} schedule.
        if latent_depths is None or latent_depths == ():
            self.latent_depths = ()
        elif latent_depths is True:
            self.latent_depths = self.policy.default_latent_depths()
        else:
            depths = tuple(sorted({int(k) for k in latent_depths}))
            if any(not 0 < k < self.policy.steps_ref for k in depths):
                raise ValueError(
                    f"latent_depths must satisfy 0 < k < steps_ref="
                    f"{self.policy.steps_ref}, got {depths}")
            self.latent_depths = depths
        self.policy.latent_depths = self.latent_depths
        self.scheduler.policy = self.policy
        self.scheduler.latency_model = self.latency_model
        self.pipeline = pipeline or ServePipeline()
        self.stats = ServeStats()
        self.clock = 0.0

    # ------------------------------------------------------------------ serve

    def serve(self, prompt: str, *, seed: int = 0, quality_tier: bool = False,
              ) -> ServeResult:
        """Serve one request: a batch of one through the staged pipeline
        (pre-pipeline compatibility signature)."""
        return self.serve_batch([prompt], seeds=[seed],
                                quality_tiers=[quality_tier])[0]

    def serve_batch(self, prompts: Sequence[str], *,
                    seeds: Optional[Sequence[int]] = None,
                    quality_tiers: Optional[Sequence[bool]] = None,
                    submitted_ats: Optional[Sequence[float]] = None,
                    ) -> List[ServeResult]:
        """Serve a micro-batch through one pass of the staged pipeline.

        Amortisation vs. a request-at-a-time loop (see
        ``repro_torch.core.pipeline`` for the per-stage contracts):

        * ONE ``embed_text`` call for every prompt in the batch;
        * ONE ``RequestScheduler.schedule_batch`` (single history matmul,
          single node-representation similarity);
        * ONE ``VectorDB.search_batch`` per node touched by the batch;
        * ONE vectorised ``score_candidates`` matmul per request (no
          per-candidate Python scoring calls);
        * denoiser calls grouped by (node, workflow, steps) and executed
          as single batched ``GenerationBackend`` calls.

        Semantics: scheduling and retrieval see the cache state at batch
        entry (snapshot), and archives land after generation.  Requests
        whose prompt near-duplicates an earlier in-batch request that will
        archive are coalesced onto that request's result — exactly the
        history fast path the sequential loop takes once the earlier
        result is recorded.  A batched drain therefore matches a
        sequential loop whenever distinct in-batch prompts do not interact
        through freshly archived images (the parity tests pin this on a
        fixed Zipf trace).  Results come back in submission order.

        ``submitted_ats`` (optional, ``time.perf_counter`` clock) lets the
        caller stamp when each request was submitted; each result's
        ``queue_delay`` then reports the time actually waited before the
        pipeline admitted it.  Results always carry ``wall_total`` and
        per-stage ``stage_walls`` from the pipeline timestamps.
        """
        states = self.pipeline.run(self, prompts, seeds=seeds,
                                   quality_tiers=quality_tiers,
                                   submitted_ats=submitted_ats)
        return [s.result for s in states]

    # ------------------------------------------------------------- internals

    def _archive(self, prompt: str, pvec: np.ndarray, img: np.ndarray,
                 node: int, *, t: Optional[float] = None,
                 seed: int = 0) -> None:
        """Store the generated image to NFS (blob store) + insert into VDB.

        With the latent-depth cache on (and a backend that supports it),
        the finished image's noised img2img intermediates at every
        configured depth are archived alongside it in the SAME
        ``VectorDB.add`` call — one stacked insert, so the device slab /
        cluster row update stays one batched write.  Latent rows share
        the finished image's embedding vectors (retrieval matches the
        image semantics; depth only changes where the chain resumes) and
        carry ``depth``/``source_id`` metadata host-side."""
        pid = self.blob_store.put(img)
        ivec = self.embedder.embed_image(img[None])[0]
        t = self.clock if t is None else t
        depths = self.latent_depths
        if depths and getattr(self.backend, "supports_latent_resume", False):
            lat = self.backend.archive_latents_batch(
                np.asarray(img)[None], [seed], depths,
                self.policy.steps_ref)
            lat_pids = [self.blob_store.put(np.asarray(lat[j][0]))
                        for j in range(len(depths))]
            rows = 1 + len(depths)
            self.dbs[node].add(
                np.repeat(ivec[None], rows, axis=0),
                np.repeat(pvec[None], rows, axis=0),
                np.array([pid, *lat_pids]), t,
                depths=np.array([-1, *depths], np.int64),
                source_ids=np.full((rows,), pid, np.int64))
        else:
            self.dbs[node].add(ivec[None], pvec[None], np.array([pid]), t)
        self.scheduler.record_result(pvec, pid)

    def _finish(self, img, route, node, score, wall, *, steps, retrieved=True,
                fast=None, resumed_from=-1, degraded=False) -> ServeResult:
        speed = (self.scheduler.nodes[node].speed if 0 <= node < len(self.dbs)
                 else max(n.speed for n in self.scheduler.nodes))
        lat = self.latency_model.latency(route, steps, node_speed=speed,
                                         scheduled=self.use_scheduler,
                                         retrieved=retrieved,
                                         resumed=resumed_from >= 0)
        gpu_s = steps * self.latency_model.t_step / max(speed, 1e-9)
        self.cost_model.charge(max(node, 0), gpu_s,
                               vdb_seconds=self.latency_model.t_retrieve if retrieved else 0.0)
        res = ServeResult(image=img, route=route, node=node, score=score,
                          latency=lat, wall_latency=wall,
                          steps=steps, fast_path=fast,
                          resumed_from=resumed_from, degraded=degraded)
        self.stats.record(res)
        return res

    def maintain(self) -> Dict[int, np.ndarray]:
        """Run the eviction policy across all node VDBs (Algorithm 2)."""
        evicted = self.eviction.maintain(self.dbs, self.cache_capacity)
        all_payloads = []
        for _, payloads in evicted.items():
            for p in payloads:
                self.blob_store.delete(int(p))
                all_payloads.append(int(p))
        # keep the historical-query cache consistent with the blob store
        self.scheduler.invalidate_payloads(all_payloads)
        return evicted

    def fail_node(self, node: int) -> None:
        """GRACEFUL edge-node failure: reassign its VDB shard, stop
        routing to it.

        Hardened edges (pinned by tests): an unknown node index raises
        :class:`repro_torch.core.scheduler.UnknownNodeError`; failing an
        already-dead node is a NO-OP (a second call must not re-run the
        classifier reassignment, which would shrink its centroids
        again); failing the last alive node raises ``RuntimeError`` —
        an empty fleet cannot serve."""
        self.scheduler._check_node(node)
        if not self.scheduler.nodes[node].alive:
            return
        if sum(n.alive for n in self.scheduler.nodes) == 1:
            raise RuntimeError(
                f"cannot fail node {node}: it is the last alive node")
        self.scheduler.mark_failed(node)
        if self.classifier is not None:
            alive = [n.index for n in self.scheduler.nodes if n.alive]
            self.classifier.reassign_failed_node(self.dbs, node, self.clock,
                                                 survivors=alive)

    def crash_node(self, node: int) -> VectorDB:
        """HARD crash: the node stops routing and its in-memory cache is
        LOST — unlike :meth:`fail_node`, nothing is reassigned (a crash
        takes its data down with it; durability comes from the node's
        :class:`repro_torch.core.journal.CacheJournal`, if one was attached).
        The node's ``VectorDB`` is swapped for a fresh empty one and the
        cluster slabs are re-stacked.  Returns the dead db (diagnostic
        surface — e.g. to compare against a journal replay)."""
        self.scheduler._check_node(node)
        if not self.scheduler.nodes[node].alive:
            raise RuntimeError(f"node {node} is already dead")
        if sum(n.alive for n in self.scheduler.nodes) == 1:
            raise RuntimeError(
                f"cannot crash node {node}: it is the last alive node")
        self.scheduler.mark_failed(node)
        old = self.dbs[node]
        old.detach_journal()
        fresh = VectorDB(old.dim, old.capacity, name=old.name,
                         use_pallas=old.use_pallas, device=old.device)
        if self.cluster_index is not None:
            old.unregister_cluster(self.cluster_index)
        self.dbs[node] = fresh
        self._restack_cluster()
        return old

    def rejoin_node(self, node: int,
                    db: Optional[VectorDB] = None) -> None:
        """Rejoin a failed/crashed node through the join-path machinery
        (scheduler slot revived, cluster slabs re-stacked via
        ``ClusterIndex.from_dbs`` — ONE upload, same as :meth:`join_node`).

        ``db`` replaces the node's current ``VectorDB`` before rejoining —
        the durability path hands a ``CacheJournal.replay`` result here so
        the node comes back with its pre-crash cache instead of cold.
        ``None`` rejoins with whatever the node holds (empty after a
        crash, its old shard after a graceful fail)."""
        self.scheduler._check_node(node)
        if self.scheduler.nodes[node].alive:
            raise RuntimeError(f"node {node} is alive — nothing to rejoin")
        if db is not None:
            cur = self.dbs[node]
            if (db.dim, db.capacity) != (cur.dim, cur.capacity):
                raise ValueError(
                    f"replacement db shape ({db.dim}, {db.capacity}) != "
                    f"node {node} shape ({cur.dim}, {cur.capacity})")
            if self.cluster_index is not None:
                cur.unregister_cluster(self.cluster_index)
            self.dbs[node] = db
        self.scheduler.mark_alive(node)
        self._restack_cluster()

    def _restack_cluster(self) -> None:
        """Rebuild the device-resident cluster slabs from the fleet's
        current numpy state (one upload; see :meth:`join_node`)."""
        if self.cluster_index is None:
            return
        for d in self.dbs:
            d.unregister_cluster(self.cluster_index)
        self.cluster_index = self._build_cluster_index()

    def _build_cluster_index(self) -> ClusterIndex:
        """The fleet's cluster index, on the mesh's devices where there
        is a mesh (a join may change the padding and every shard
        boundary)."""
        return ClusterIndex.from_dbs(
            self.dbs, mesh_nodes=self.mesh_nodes, device=self.device,
            mesh_devices=None if self.mesh is None else self.mesh.devices)

    def join_node(self, *, speed: float = 1.0,
                  capacity: Optional[int] = None) -> int:
        """Graceful node JOIN: grow the fleet by one fresh, empty node.

        The new node gets its own ``VectorDB`` (``capacity`` defaults to
        node 0's), a scheduler slot at ``speed``, and a share of the
        fleet cache budget (``cache_capacity`` grows by the new node's
        capacity).  The device-resident ``ClusterIndex`` slabs are
        fixed-shape ``(2, nodes, capacity, dim)``, so a join re-stacks
        them once from the fleet's numpy state (ONE upload — the same
        cost as construction; steady-state incremental updates resume
        immediately after).  Safe between micro-batches: routing reads
        the fleet only at batch admission, so callers (e.g. the
        front-door dispatcher) apply joins at group boundaries.

        Returns the new node's index.  The storage classifier's K-means
        centroids are left untouched — the joined node earns its
        semantic identity from the archives routed to it.
        """
        if not self.dbs:
            raise RuntimeError("cannot join a node into an empty fleet")
        ref = self.dbs[0]
        cap = int(capacity) if capacity is not None else ref.capacity
        if cap < 1:
            raise ValueError(f"capacity must be >= 1, got {cap}")
        node = len(self.dbs)
        db = VectorDB(ref.dim, cap, name=f"node{node}",
                      use_pallas=ref.use_pallas, device=ref.device)
        self.dbs.append(db)
        self.scheduler.add_node(speed=speed)
        self.cache_capacity += cap
        self._restack_cluster()
        return node

    @property
    def total_size(self) -> int:
        return sum(db.size for db in self.dbs)
