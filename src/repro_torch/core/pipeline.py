"""Staged serving pipeline — the Fig. 5 request path as explicit stages.

Every request batch flows through the same eight named, batch-first stages:

    Embed -> Schedule -> Retrieve -> Score -> Plan -> Generate
          -> Archive -> Finish

with a typed :class:`RequestState` carried per request (prompt, embedding,
schedule decision, retrieval rows, :class:`Plan`, image, result).  This is
the ONLY request path: ``CacheGenius.serve`` is a batch of one, so the
sequential and batched behaviours agree by construction.

Stage contracts (each stage sees the whole micro-batch):

* **Embed**     — prompt optimisation + ONE ``embed_text`` call.
* **Schedule**  — ONE ``RequestScheduler.schedule_batch`` (single history
  matmul, single node-representation similarity).  In score-aware routing
  mode (``system.routing == "score"``, the default with a cluster index)
  it ALSO issues the micro-batch's one cluster-wide device scan
  (``ClusterIndex.search_cluster_nodes``): every request's top-k on EVERY
  node feeds both the per-node best-composite routing matrix and —
  stashed on the state — the chosen node's retrieval candidates.
* **Retrieve**  — ONE fused ``ClusterIndex.search_batch`` device scan for
  the WHOLE micro-batch (all touched nodes, both dual-retrieval indexes,
  query→node masked); a no-op in score mode (the Schedule scan already
  produced every chosen node's rows, so Schedule+Retrieve = ONE scan
  total); per-node ``VectorDB.search_batch`` only as the no-cluster
  fallback.
* **Score**     — composite Eq. 7 scoring of every request's candidate set
  via ``Embedder.score_candidates`` — one vectorised matmul per request,
  never per-candidate Python ``clip_score``/``pick_score`` calls; lazily
  evaluated so requests the Plan stage coalesces never pay for it.
* **Plan**      — Algorithm 1 routing in submission order, coalescing
  near-duplicates of in-flight batch members onto one generation.  With
  the latent-depth cache enabled the binary img2img/txt2img split refines
  into a DEPTH schedule: a band request resumes the denoising chain from
  the deepest archived latent at or below ``policy.resume_depth(score)``
  (see :meth:`PlanStage._depth_plan`).
* **Generate**  — denoiser calls grouped by (node, workflow, steps) —
  resume plans additionally by depth — and issued through the batch-first
  :class:`GenerationBackend` protocol.
* **Archive**   — blob-store put + VDB insert in submission order, up to
  the batch's first interior maintenance crossing; later archives defer
  to the Finish stage so the sweep sees exactly the same cache state it
  would sequentially.
* **Finish**    — stats, Eq. 8 latency, exact-crossing maintenance,
  ``ServeResult``.

Semantics (pinned by the parity tests): scheduling and retrieval see the
cache state at batch entry (snapshot), archives land after generation in
submission order, and a batch of one is exactly the sequential loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import Route
from repro_torch.core.scheduler import ScheduleDecision
from repro_torch.utils import l2n, stable_hash


class TransientBackendError(RuntimeError):
    """A denoiser call failed in a way worth retrying (flaky accelerator,
    dropped RPC).  The Generate stage retries the group up to
    ``system.transient_retries`` times, charging each attempt to the
    node's health; the front-door dispatcher adds backoff on top."""


class CorruptReferenceError(RuntimeError):
    """An archived blob failed its checksum at hit time.  Raised by the
    Plan stage's verified fetches AFTER the corrupt entry has been purged
    (VDB slots evicted, blob deleted, history invalidated); the stage
    catches it and degrades the request to the txt2img miss path."""


# ---------------------------------------------------------------------------
# generation backend — batch-first protocol
# ---------------------------------------------------------------------------


class GenerationBackend:
    """Batch-first generation protocol.

    Subclasses implement the two REQUIRED batched entry points:

    ``txt2img_batch(prompts, steps, seeds) -> (B, H, W, 3)``
        One denoiser call for a whole same-step group.
    ``img2img_batch(prompts, references, steps, seeds) -> (B, H, W, 3)``
        Batched SDEdit over stacked references ``(B, H, W, 3)``.

    The scalar ``txt2img`` / ``img2img`` entry points derive automatically
    as a batch of one — override them only when a dedicated scalar path is
    cheaper (``DiffusionBackend`` does, to skip the batch plumbing).  A
    subclass that overrides ONLY the scalar methods (the old per-request
    surface) still works: the batched entry points fall back to a
    per-request loop over them.

    Migration note for pre-redesign callers: ``GenerationBackend`` used to
    be a dataclass of four optional callables.  Constructing
    ``GenerationBackend(txt2img=f, img2img=g, ...)`` still works — the
    callables are wrapped (see :class:`CallableBackend`), with missing
    batch callables falling back to a per-request loop, exactly the old
    serve-path fallback.
    """

    # legacy (txt2img, img2img, txt2img_batch, img2img_batch) callables;
    # the class-level default covers subclasses that skip __init__
    _fns: Tuple = (None, None, None, None)

    # latent-depth cache surface (optional): backends that can archive
    # noised intermediates of the img2img chain and resume denoising from
    # them flip this on and implement the two methods below
    supports_latent_resume: bool = False

    def __init__(self, txt2img=None, img2img=None, txt2img_batch=None,
                 img2img_batch=None):
        self._fns = (txt2img, img2img, txt2img_batch, img2img_batch)

    # -- required batched surface -------------------------------------------

    def txt2img_batch(self, prompts: Sequence[str], steps: int,
                      seeds: Sequence[int]) -> np.ndarray:
        fn_scalar, _, fn_batch, _ = self._fns
        if fn_batch is not None:
            return np.asarray(fn_batch(prompts, steps, seeds))
        if fn_scalar is None and type(self).txt2img is not \
                GenerationBackend.txt2img:
            # subclass migrated only the scalar surface: loop over it
            fn_scalar = self.txt2img
        if fn_scalar is not None:
            return np.stack([np.asarray(fn_scalar(p, steps, s))
                             for p, s in zip(prompts, seeds)])
        raise NotImplementedError(
            "GenerationBackend subclasses must implement txt2img_batch")

    def img2img_batch(self, prompts: Sequence[str], references: np.ndarray,
                      steps: int, seeds: Sequence[int]) -> np.ndarray:
        _, fn_scalar, _, fn_batch = self._fns
        if fn_batch is not None:
            return np.asarray(fn_batch(prompts, references, steps, seeds))
        if fn_scalar is None and type(self).img2img is not \
                GenerationBackend.img2img:
            fn_scalar = self.img2img
        if fn_scalar is not None:
            return np.stack([np.asarray(fn_scalar(p, r, steps, s))
                             for p, r, s in zip(prompts, references, seeds)])
        raise NotImplementedError(
            "GenerationBackend subclasses must implement img2img_batch")

    # -- derived scalar surface ---------------------------------------------

    def txt2img(self, prompt: str, steps: int, seed: int) -> np.ndarray:
        fn_scalar = self._fns[0]
        if fn_scalar is not None:
            return np.asarray(fn_scalar(prompt, steps, seed))
        return np.asarray(self.txt2img_batch([prompt], steps, [seed]))[0]

    def img2img(self, prompt: str, reference: np.ndarray, steps: int,
                seed: int) -> np.ndarray:
        fn_scalar = self._fns[1]
        if fn_scalar is not None:
            return np.asarray(fn_scalar(prompt, reference, steps, seed))
        return np.asarray(self.img2img_batch(
            [prompt], np.asarray(reference)[None], steps, [seed]))[0]

    # -- latent-depth cache surface (optional) --------------------------------

    def archive_latents_batch(self, images: np.ndarray,
                              seeds: Sequence[int],
                              depths: Sequence[int],
                              steps_total: int) -> np.ndarray:
        """Noised intermediates of each image's ``steps_total``-step
        img2img chain at every requested depth — shape
        ``(len(depths), B, ...)``.  The depth-k latent must equal what
        ``resume_batch(..., k=k)`` expects as its starting state, and the
        per-image noise draw must reuse the image's archive ``seed`` so
        resumed trajectories are reproducible."""
        raise NotImplementedError(
            "backend does not support latent archiving "
            "(supports_latent_resume is False)")

    def resume_batch(self, prompts: Sequence[str], latents: np.ndarray,
                     steps_total: int, k: int,
                     seeds: Sequence[int]) -> np.ndarray:
        """Resume the ``steps_total``-step img2img chain from depth ``k``
        (running ``steps_total - k`` denoising steps) for a stacked batch
        of archived latents — returns decoded images ``(B, H, W, 3)``.
        ``k == 0`` must reproduce ``img2img_batch`` exactly (same chain,
        same starting state)."""
        raise NotImplementedError(
            "backend does not support latent resume "
            "(supports_latent_resume is False)")


class CallableBackend(GenerationBackend):
    """Adapter: legacy per-request callables (plus optional batch callables)
    wrapped into the batch-first protocol.  Identical to constructing
    ``GenerationBackend`` with callables directly; the explicit name marks
    migration sites."""


# ---------------------------------------------------------------------------
# per-request state
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    """Typed per-request execution plan (replaces the old anonymous dicts).

    ``kind`` is one of:

    * ``"alias"``   — coalesce onto in-flight batch member ``target``;
    * ``"history"`` — historical-query fast path, ``image`` already fetched;
    * ``"cached"``  — Algorithm 1 HIT_RETURN, ``image`` already fetched;
    * ``"gen"``     — run the denoiser (txt2img; img2img when ``ref`` is
      set; latent-depth resume when ``latent`` is set, running
      ``steps = K - resume_k`` remaining chain steps); ``fast`` marks the
      quality-priority fast path.
    """

    kind: str
    node: int = -1
    route: Optional[Route] = None
    steps: int = 0
    score: float = 0.0
    fast: Optional[str] = None
    ref: Optional[np.ndarray] = None
    target: int = -1
    image: Optional[np.ndarray] = None
    resume_k: int = 0                    # latent-depth resume depth
    latent: Optional[np.ndarray] = None  # archived noised latent (depth k)
    degraded: bool = False               # corrupt reference → miss path


@dataclass
class RequestState:
    """One request's state as it flows through the stages."""

    index: int                 # position in the micro-batch
    raw_prompt: str
    prompt: str                # optimised prompt (Generate conditions on it)
    seed: int
    quality_tier: bool
    clock: float               # logical arrival tick
    submitted_at: Optional[float] = None  # caller-clock submission instant
    admitted_at: float = 0.0   # perf_counter at pipeline entry
    # perf_counter at each stage's END, in stage order (every request in
    # the micro-batch gets its own copy — coalesced duplicates included)
    stage_ts: Dict[str, float] = field(default_factory=dict)
    pkey: int = 0              # stable prompt hash (priority fast path)
    pvec: Optional[np.ndarray] = None    # text embedding
    qvec: Optional[np.ndarray] = None    # L2-normalised pvec
    decision: Optional[ScheduleDecision] = None
    ret_scores: np.ndarray = field(default_factory=lambda: np.empty(0))
    ret_slots: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))
    retrieved: bool = False    # rows already filled (score-mode Schedule)
    best_slot: int = -1
    best_score: float = -1.0
    score_thunk: Optional[Callable[[], None]] = None
    plan: Optional[Plan] = None
    image: Optional[np.ndarray] = None
    archive_deferred: bool = False  # archive lands in Finish (post-crossing)
    result: Optional[object] = None      # ServeResult (set by Finish)


@dataclass
class BatchContext:
    """Shared per-micro-batch scratch handed to every stage."""

    system: object             # CacheGenius
    states: List[RequestState]
    t_wall0: float
    pvecs: Optional[np.ndarray] = None   # (B, 512) stacked text embeddings
    # step-level admission: (qvec, handle) of every earlier gen-plan
    # request that is still in flight or awaiting finalize — requests a
    # sequential loop would already have archived.  The Plan stage seeds
    # its coalescing set with these, encoding the out-of-batch handle as
    # a NEGATIVE alias target (-(handle + 1)); the step-level driver
    # resolves those aliases when the target's image lands.  None (the
    # group-mode default) leaves Plan's behaviour untouched.
    inflight: Optional[List[Tuple[np.ndarray, int]]] = None


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _composite_scores(system, pvec: np.ndarray,
                      ivecs: np.ndarray) -> np.ndarray:
    """One vectorised Eq. 7 evaluation of a candidate set (single home of
    the scalar-embedder fallback) — shared by score-mode Schedule routing
    and the Score stage so the two can never diverge."""
    score_fn = getattr(system.embedder, "score_candidates", None)
    if score_fn is not None:
        clips, picks = score_fn(pvec, ivecs)
    else:   # custom embedders without the vectorised entry point
        clips = np.array([system.embedder.clip_score(pvec, v)
                          for v in ivecs])
        picks = np.array([system.embedder.pick_score(pvec, v)
                          for v in ivecs])
    return system.policy.composite_scores(clips, picks)


class EmbedStage:
    name = "Embed"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        raw = [s.raw_prompt for s in ctx.states]
        if system.use_prompt_optimizer:
            for s in ctx.states:
                s.prompt = system.prompt_optimizer.optimize(s.raw_prompt)
        ctx.pvecs = system.embedder.embed_text(raw)     # one batched call
        qn = l2n(ctx.pvecs)
        for s, pv, qv in zip(ctx.states, ctx.pvecs, qn):
            s.pvec = pv
            s.qvec = qv
            s.pkey = stable_hash(s.raw_prompt, 1 << 62)


class ScheduleStage:
    """ONE routing pass for the whole micro-batch.

    Centroid mode: one ``RequestScheduler.schedule_batch`` call (single
    history matmul, single node-representation similarity).

    Score mode (``system.routing == "score"`` with a cluster index): the
    stage additionally issues the micro-batch's single cluster-wide
    device scan — ``ClusterIndex.search_cluster_nodes`` — so every
    request sees its top-k candidates on EVERY node.  Per-node best
    composite (Eq. 7) scores are computed with the same vectorised
    ``score_candidates`` path the Score stage uses and handed to
    ``schedule_batch(node_scores=...)``; the chosen node's candidate row
    (bit-identical to what a masked retrieval scan would return) is then
    stashed on the state, making the Retrieve stage a no-op.  Schedule +
    Retrieve therefore cost exactly ONE device scan per micro-batch,
    pinned by the call-count test in ``tests/test_scheduling_score.py``.
    The contract is mesh-transparent: with a sharded cluster index
    (``mesh_nodes > 1``) the same single call launches one scan per
    shard, each on its shard's device — still one ``fused_scans`` tick,
    still bitwise-identical routing (pinned by
    ``tests/test_torch_mesh.py``).
    """

    name = "Schedule"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        if not system.use_scheduler:
            for s in ctx.states:
                s.decision = ScheduleDecision(
                    node=int(s.clock) % len(system.dbs))
            return
        cluster = getattr(system, "cluster_index", None)
        node_rows = None
        node_best = None
        best_details = None
        if getattr(system, "routing", "centroid") == "score" \
                and cluster is not None:
            node_rows = cluster.search_cluster_nodes(ctx.pvecs, system.topk)
            node_best, best_details = self._node_best_scores(
                system, ctx, node_rows)
        decisions = system.scheduler.schedule_batch(
            ctx.pvecs, system.dbs,
            quality_tiers=[s.quality_tier for s in ctx.states],
            prompt_keys=[s.pkey for s in ctx.states],
            node_scores=node_best)
        for s, d in zip(ctx.states, decisions):
            s.decision = d
            if node_rows is not None and d.fast_path is None:
                s.ret_scores, s.ret_slots = node_rows[s.index][d.node]
                s.retrieved = True
                # routing already composite-scored the chosen node's
                # candidates — reuse its argmax so the Score stage never
                # re-scores them (one scoring matmul per request, total)
                picked = best_details[s.index].get(d.node)
                if picked is not None:
                    s.best_slot, s.best_score = picked
                db = system.dbs[d.node]
                db.query_count += 1       # same accounting as a masked scan

    @staticmethod
    def _node_best_scores(system, ctx: BatchContext, node_rows):
        """Score-mode routing input: a (B, nodes) matrix of each
        request's best composite Eq. 7 score per node (0.0 where a node
        holds no valid candidate), plus per-request ``{node: (slot,
        score)}`` argmax details so the chosen node's best is reused
        downstream instead of re-scored.  One vectorised
        ``score_candidates`` call per request over ALL nodes' candidates;
        embedders without the vectorised entry point fall back to scalar
        calls via the shared :func:`_composite_scores` helper."""
        n_nodes = len(system.dbs)
        best = np.zeros((len(ctx.states), n_nodes))
        details: List[Dict[int, Tuple[int, float]]] = \
            [{} for _ in ctx.states]
        for s in ctx.states:
            spans = []
            cand_vecs = []
            for node in range(n_nodes):
                _, slots = node_rows[s.index][node]
                cand_vecs.append(system.dbs[node].img_vecs[slots])
                spans.append(len(slots))
            if not sum(spans):
                continue
            comp = _composite_scores(system, s.pvec,
                                     np.concatenate(cand_vecs))
            off = 0
            for node, n in enumerate(spans):
                if n:
                    j = int(np.argmax(comp[off:off + n]))
                    slot = int(node_rows[s.index][node][1][j])
                    score = float(comp[off + j])
                    best[s.index, node] = score
                    details[s.index][node] = (slot, score)
                off += n
        return best, details


class RetrieveStage:
    """ONE fused device scan per micro-batch: all retrieval-path queries
    against all touched node slabs through the cluster's device-resident
    index (``ClusterIndex.search_batch`` with the query→node mask) —
    never a per-node Python loop, never a host→device slab copy.  Under
    score-aware routing the Schedule stage's cluster-wide scan already
    filled every chosen node's rows (``state.retrieved``), so this stage
    issues NOTHING — Schedule+Retrieve collapse to one scan.  The scan
    is mesh-transparent: a sharded index (``mesh_nodes > 1``) serves the
    identical call from per-device node shards with bitwise-equal
    results.  Systems without a cluster index (custom stage lists,
    standalone fleets) fall back to the per-node ``VectorDB.search_batch``
    grouping."""

    name = "Retrieve"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        members = [s for s in ctx.states
                   if s.decision.fast_path is None and not s.retrieved]
        if not members:
            return
        cluster = getattr(system, "cluster_index", None)
        if cluster is not None:
            idxs = [m.index for m in members]
            nodes = [m.decision.node for m in members]
            rows = cluster.search_batch(ctx.pvecs[idxs], nodes, system.topk)
            for m, (scores, slots) in zip(members, rows):
                m.ret_scores, m.ret_slots = scores, slots
            return
        by_node: Dict[int, List[RequestState]] = {}
        for m in members:
            by_node.setdefault(m.decision.node, []).append(m)
        for node, group in by_node.items():
            idxs = [m.index for m in group]
            rows = system.dbs[node].search_batch(ctx.pvecs[idxs], system.topk)
            for m, (scores, slots) in zip(group, rows):
                m.ret_scores, m.ret_slots = scores, slots


class ScoreStage:
    """Attach a lazy, vectorised Eq. 7 scorer to every retrieval-path
    request.  Evaluation is ONE ``score_candidates`` matmul per request —
    never per-candidate Python ``clip_score``/``pick_score`` calls — and
    is deferred to the Plan walk: whether a request coalesces onto an
    in-flight batch member is only decidable there, and coalesced
    requests must not pay for scoring (the pre-pipeline loop checked
    dedup before scoring too).  The candidate snapshot is unchanged by
    the deferral: Plan only touches access stats, archives land later.

    Score-mode requests arrive already scored: routing composite-scored
    every node's candidates at schedule time, and the chosen node's
    argmax was stashed as ``best_slot``/``best_score`` — this stage
    attaches no thunk for them (one scoring matmul per request, total).
    """

    name = "Score"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        for s in ctx.states:
            if s.decision.fast_path is not None or len(s.ret_slots) == 0:
                continue
            if s.best_slot >= 0:
                continue    # score-mode Schedule already picked the best
            s.score_thunk = self._make_thunk(system, s)

    @staticmethod
    def _make_thunk(system, s: RequestState):
        def evaluate() -> None:
            db = system.dbs[s.decision.node]
            comp = _composite_scores(system, s.pvec, db.img_vecs[s.ret_slots])
            j = int(np.argmax(comp))
            s.best_slot = int(s.ret_slots[j])
            s.best_score = float(comp[j])
            s.score_thunk = None

        return evaluate


class PlanStage:
    """Algorithm 1 routing in submission order.  Near-duplicates of
    in-flight (will-archive) batch members coalesce onto that member's
    generation — exactly the history fast path the sequential loop takes
    once the earlier result is recorded.

    Every blob this stage fetches (history image, cached return, img2img
    reference, archived latent) goes through a verified fetch: a blob
    whose bytes no longer match the CRC recorded at archive time is
    PURGED (VDB slots evicted — journaled like any eviction — blob
    deleted, scheduler history invalidated, a fault charged to the owning
    node's health) and the request DEGRADES to the full txt2img miss path
    — a correct image at full step cost, never a result conditioned on
    garbage (``Plan.degraded`` marks these for the stats)."""

    name = "Plan"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        pending_vecs: List[np.ndarray] = []
        pending_req: List[int] = []
        if ctx.inflight:
            # step-level admission: earlier unfinalized gen requests join
            # the coalescing set first (they precede this batch in
            # submission order), with negative-encoded handles as targets
            for qv, handle in ctx.inflight:
                pending_vecs.append(qv)
                pending_req.append(-(int(handle) + 1))
        for s in ctx.states:
            pend_sim, pend_j = -np.inf, -1
            if pending_vecs:
                sims = np.stack(pending_vecs) @ s.qvec
                pj = int(np.argmax(sims))
                pend_sim, pend_j = float(sims[pj]), pending_req[pj]
            try:
                self._plan_one(system, s, pend_sim, pend_j)
            except CorruptReferenceError:
                self._degrade(system, s)
            if s.plan.kind == "gen":
                pending_vecs.append(s.qvec)
                pending_req.append(s.index)

    def _plan_one(self, system, s: RequestState, pend_sim: float,
                  pend_j: int) -> None:
        """Set ``s.plan`` for one request (the Algorithm 1 walk body).
        Raises :class:`CorruptReferenceError` if any blob it needs fails
        verification — the caller degrades the request."""
        d = s.decision
        if d.fast_path == "history":
            if pend_sim > d.match_score:   # later history entry wins
                s.plan = Plan(kind="alias", target=pend_j)
            else:
                s.plan = Plan(kind="history", image=self._fetch_payload(
                    system, int(d.history_payload)))
            return
        if (system.use_scheduler
                and pend_sim >= system.scheduler.dedup_threshold):
            # sequential serve would history-hit the in-flight record
            system.scheduler.count_history_hit()
            system.scheduler.uncount_prompt(s.pkey)
            s.plan = Plan(kind="alias", target=pend_j)
            return
        node = d.node
        if d.fast_path == "priority":
            s.plan = Plan(kind="gen", node=node, route=Route.TXT2IMG,
                          steps=system.policy.steps_full,
                          fast="priority", score=0.0)
            return
        if s.score_thunk is not None:
            s.score_thunk()
        db = system.dbs[node]
        route = (system.policy.route(s.best_score) if s.best_slot >= 0
                 else Route.TXT2IMG)
        steps = system.policy.steps_for(route)
        if route is not Route.TXT2IMG:
            plan = self._depth_plan(system, s, db, node, route)
            if plan is not None:
                s.plan = plan
                return
        if route is Route.HIT_RETURN:
            s.plan = Plan(kind="cached", node=node, score=s.best_score,
                          image=self._fetch_slot(system, db, s.best_slot,
                                                 s.clock))
        elif route is Route.IMG2IMG:
            s.plan = Plan(kind="gen", node=node, route=route, steps=steps,
                          score=s.best_score,
                          ref=self._fetch_slot(system, db, s.best_slot,
                                               s.clock))
        else:
            s.plan = Plan(kind="gen", node=node, route=route, steps=steps,
                          score=s.best_score)

    # -- verified fetches / degraded mode -------------------------------------

    @staticmethod
    def _fetch_payload(system, payload: int) -> np.ndarray:
        """Blob fetch with verify-on-hit: checksum-failing blobs are
        quarantined and the fetch raises instead of returning bytes."""
        store = system.blob_store
        verify = getattr(store, "verify", None)
        if verify is not None and not verify(payload):
            PlanStage._quarantine(system, payload)
            raise CorruptReferenceError(
                f"archived blob {payload} failed its checksum")
        return store.get(payload)

    @staticmethod
    def _fetch_slot(system, db, slot: int, clock: float) -> np.ndarray:
        """Verified fetch of a VDB slot's blob; marks the access (exactly
        the pre-verify behaviour) only once the bytes check out."""
        payload = int(db.payload_ids[slot])
        store = system.blob_store
        verify = getattr(store, "verify", None)
        if verify is not None and not verify(payload):
            PlanStage._quarantine(system, payload)
            raise CorruptReferenceError(
                f"archived blob {payload} failed its checksum")
        db.mark_access(np.array([slot]), clock)
        return store.get(payload)

    @staticmethod
    def _quarantine(system, payload: int) -> None:
        """Purge one checksum-failing blob everywhere it is referenced:
        evict its VDB slots (journaled like any eviction, cluster rows
        invalidated by the eviction observer), delete the blob, drop it
        from scheduler history, and charge a fault to the owning node's
        health.  After this no path can ever serve the bytes."""
        owner = -1
        for node, db in enumerate(getattr(system, "dbs", ())):
            slots = np.flatnonzero(db.valid & (db.payload_ids == payload))
            if len(slots):
                if owner < 0:
                    owner = node
                db.evict_slots(slots)
        system.blob_store.delete(payload)
        if getattr(system, "use_scheduler", False):
            system.scheduler.invalidate_payloads([payload])
            if owner >= 0:
                system.scheduler.observe_fault(owner, kind="corrupt")
        stats = getattr(system, "stats", None)
        if stats is not None:
            stats.corrupt_hits += 1

    @staticmethod
    def _degrade(system, s: RequestState) -> None:
        """Corrupt reference detected mid-plan: serve the request through
        the full txt2img miss path (correct image, full step cost).  The
        corrupt entry was already purged by :meth:`_quarantine`."""
        node = s.decision.node
        if node < 0:    # history fast path carries no node
            if getattr(system, "use_scheduler", False):
                node = max(system.scheduler._routable_nodes(),
                           key=lambda n: n.speed).index
            else:
                node = int(s.clock) % len(system.dbs)
        s.plan = Plan(kind="gen", node=node, route=Route.TXT2IMG,
                      steps=system.policy.steps_full, score=0.0,
                      degraded=True)

    @staticmethod
    def _depth_plan(system, s: RequestState, db, node: int,
                    route: Route) -> Optional[Plan]:
        """Latent-depth refinement of a HIT_RETURN/IMG2IMG route.

        The matched slot's ``source_id`` groups all entries archived from
        the same finished image — the image itself (depth -1) plus its
        noised latents (depth k).  HIT_RETURN ships the finished image
        when it survives eviction, else resumes from the DEEPEST sibling
        latent.  An img2img-band request maps its composite score to a
        desired depth (``policy.resume_depth``) and resumes from the
        deepest archived latent at or below it; with only deeper latents
        left it resumes from the shallowest one (conservative overshoot —
        still fewer steps than full img2img), and with only the finished
        image left it falls back to the classic SDEdit plan (return
        ``None``).  Returns ``None`` whenever the depth schedule is off,
        the backend cannot resume, or the slot carries no depth metadata —
        the caller then runs the classic Algorithm 1 plan unchanged."""
        if not getattr(system, "latent_depths", ()):
            return None
        if not getattr(system.backend, "supports_latent_resume", False):
            return None
        src = int(db.source_id[s.best_slot])
        if src < 0:
            return None
        sib = np.flatnonzero(db.valid & (db.source_id == src))
        lat = {int(db.depth[i]): int(i) for i in sib if db.depth[i] >= 0}
        fin = [int(i) for i in sib if db.depth[i] < 0]
        # retrieval can argmax ANY sibling row (latents share the finished
        # image's vectors), so the classic fallback is only safe when the
        # matched slot itself is a finished image — otherwise build the
        # equivalent plan here against the finished sibling explicitly
        matched_finished = int(db.depth[s.best_slot]) < 0

        def resume(k: int, slot: int) -> Plan:
            return Plan(kind="gen", node=node, route=Route.IMG2IMG,
                        steps=system.policy.steps_for_resume(k),
                        score=s.best_score, resume_k=k,
                        latent=PlanStage._fetch_slot(system, db, slot,
                                                     s.clock))

        if route is Route.HIT_RETURN:
            if fin:
                if matched_finished:
                    return None         # classic cached return
                slot = fin[0]
                return Plan(kind="cached", node=node, score=s.best_score,
                            image=PlanStage._fetch_slot(system, db, slot,
                                                        s.clock))
            if not lat:
                return None
            k = max(lat)                # strongest match → resume deepest
            return resume(k, lat[k])
        # IMG2IMG band: depth schedule
        if not lat:
            return None                 # only the finished image survives
        desired = system.policy.resume_depth(s.best_score)
        usable = [k for k in lat if k <= desired]
        if usable:
            k = max(usable)
        elif fin:
            # classic img2img beats overshooting a too-deep latent
            if matched_finished:
                return None
            slot = fin[0]
            return Plan(kind="gen", node=node, route=Route.IMG2IMG,
                        steps=system.policy.steps_for(Route.IMG2IMG),
                        score=s.best_score,
                        ref=PlanStage._fetch_slot(system, db, slot,
                                                  s.clock))
        else:
            k = min(lat)                # overshoot: shallowest latent left
        return resume(k, lat[k])


class GenerateStage:
    """One padded backend call per (node, workflow, steps) group; latent
    resumes additionally group by depth (same AOT bucket family — one
    compiled program per (resume depth, steps, batch bucket)).

    Every backend call runs through :meth:`_call`: a
    :class:`TransientBackendError` is retried up to
    ``system.transient_retries`` times, with each failed attempt charged
    to the group's node health (``scheduler.observe_fault``) and each
    success clearing the streak (``observe_ok``) — fault-free runs keep
    health at exactly 1.0, so routing stays bit-identical."""

    name = "Generate"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        txt_groups: Dict[tuple, List[RequestState]] = {}
        img_groups: Dict[tuple, List[RequestState]] = {}
        res_groups: Dict[tuple, List[RequestState]] = {}
        for s in ctx.states:
            if s.plan.kind != "gen":
                continue
            if s.plan.latent is not None:
                res_groups.setdefault(
                    (s.plan.node, s.plan.resume_k, s.plan.steps),
                    []).append(s)
                continue
            grp = img_groups if s.plan.ref is not None else txt_groups
            grp.setdefault((s.plan.node, s.plan.steps), []).append(s)
        for (node, steps), members in txt_groups.items():
            out = self._call(system, node, system.backend.txt2img_batch,
                             [m.prompt for m in members], steps,
                             [m.seed for m in members])
            for j, m in enumerate(members):
                m.image = np.asarray(out[j])
        for (node, steps), members in img_groups.items():
            refs = np.stack([m.plan.ref for m in members])
            out = self._call(system, node, system.backend.img2img_batch,
                             [m.prompt for m in members], refs, steps,
                             [m.seed for m in members])
            for j, m in enumerate(members):
                m.image = np.asarray(out[j])
        for (node, k, steps), members in res_groups.items():
            lats = np.stack([m.plan.latent for m in members])
            out = self._call(system, node, system.backend.resume_batch,
                             [m.prompt for m in members], lats, steps + k, k,
                             [m.seed for m in members])
            for j, m in enumerate(members):
                m.image = np.asarray(out[j])

    @staticmethod
    def _call(system, node: int, fn, *args) -> np.ndarray:
        """One backend call with transient-fault retry and health
        bookkeeping; the final failed attempt re-raises so no request is
        ever silently dropped."""
        retries = getattr(system, "transient_retries", 0)
        sched = (system.scheduler
                 if getattr(system, "use_scheduler", False) else None)
        attempt = 0
        while True:
            try:
                out = np.asarray(fn(*args))
            except TransientBackendError:
                if sched is not None and 0 <= node < len(sched.nodes):
                    sched.observe_fault(node, kind="transient")
                stats = getattr(system, "stats", None)
                if stats is not None:
                    stats.transient_retries += 1
                attempt += 1
                if attempt > retries:
                    raise
                continue
            if sched is not None and 0 <= node < len(sched.nodes):
                sched.observe_ok(node)
            return out


def _do_archive(system, s: RequestState) -> None:
    """The one archive call (blob put + VDB insert + history record) —
    shared by the Archive stage and the Finish stage's deferred flush."""
    system._archive(s.raw_prompt, s.pvec, s.image, s.plan.node,
                    t=s.clock, seed=s.seed)


class ArchiveStage:
    """Blob-store put + VDB insert in submission order (blob ids / history
    order match the sequential loop exactly).

    Exact-crossing maintenance support: archives land eagerly only up to
    the batch's first INTERIOR ``maintenance_interval`` crossing (a
    request count that is a multiple of the interval, with later requests
    still in the batch).  Requests past that boundary mark
    ``archive_deferred`` and flush inside the Finish stage's per-request
    result loop — so the eviction sweep at crossing r sees exactly the
    archives of requests 1..r, the same cache state the sequential loop
    produces, for ANY batch partitioning of the trace."""

    name = "Archive"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        interval = system.maintenance_interval
        req_no = system.stats.requests      # results not yet recorded
        boundary = None                     # index of first interior crossing
        for i in range(len(ctx.states) - 1):
            if (req_no + i + 1) % interval == 0:
                boundary = i
                break
        for i, s in enumerate(ctx.states):
            if s.plan.kind != "gen":
                continue
            if boundary is not None and i > boundary:
                s.archive_deferred = True
                continue
            _do_archive(system, s)


class FinishStage:
    """Stats, Eq. 8 latency, exact-crossing maintenance, ``ServeResult``.

    Maintenance fires at EXACT request-count crossings: the result loop
    walks the batch in submission order, flushing each request's deferred
    archive (see :class:`ArchiveStage`) before recording its result, and
    runs the eviction sweep the moment the request counter hits a
    ``maintenance_interval`` multiple — splitting result recording at the
    boundary.  The sweep at crossing r therefore sees exactly the
    archives of requests 1..r regardless of how the trace was partitioned
    into micro-batches, so intervals SMALLER than the batch size keep
    their sequential cadence too (earlier revisions coalesced sweeps at
    the group boundary and needed interval >= max_batch — the old
    ROADMAP caveat).  Remaining divergence from the sequential loop is
    confined to the batch-entry snapshot: retrieval and access marking
    inside one batch cannot see a mid-batch sweep that already happened
    sequentially.

    Wall-clock accounting: each request reports the micro-batch's total
    wall time divided by the batch size (batch-amortised per-request
    cost); the batch total itself is appended to
    ``ServeStats.batch_wall_latencies``.  The total is taken AFTER the
    result loop AND its interleaved maintenance sweeps, so sweeps stay
    inside the measurement; results and stats are back-filled with the
    final share.

    The TRUE per-request accounting (``stage_walls`` / ``wall_total`` /
    ``queue_delay``) is back-filled by the ``ServePipeline.run`` driver
    from the per-stage timestamps once the last stage returns — the
    amortised ``wall_latency`` stays only as the legacy throughput share.
    """

    name = "Finish"

    def run(self, ctx: BatchContext) -> None:
        system = ctx.system
        n = len(ctx.states)
        interval = system.maintenance_interval
        wall = 0.0          # back-filled once the batch total is known
        for s in ctx.states:
            if s.archive_deferred:
                _do_archive(system, s)
                s.archive_deferred = False
            p = s.plan
            if p.kind == "alias":
                s.image = ctx.states[p.target].image
                s.result = system._finish(
                    s.image, Route.HIT_RETURN, -1, 1.0, wall,
                    steps=0, retrieved=False, fast="history")
            elif p.kind == "history":
                s.image = p.image
                s.result = system._finish(
                    s.image, Route.HIT_RETURN, -1, 1.0, wall,
                    steps=0, retrieved=False, fast="history")
            elif p.kind == "gen" and p.fast == "priority":
                s.result = system._finish(
                    s.image, Route.TXT2IMG, p.node, 0.0, wall,
                    steps=p.steps, retrieved=False, fast="priority")
            elif p.kind == "cached":
                s.image = p.image
                s.result = system._finish(
                    s.image, Route.HIT_RETURN, p.node, p.score, wall,
                    steps=0)
            else:
                s.result = system._finish(
                    s.image, p.route, p.node, p.score, wall,
                    steps=p.steps,
                    resumed_from=(p.resume_k if p.latent is not None
                                  else -1),
                    degraded=p.degraded)
            # exact crossing: sweep the moment the counter hits a multiple
            if system.stats.requests % interval == 0:
                system.maintain()
        t_batch = time.perf_counter() - ctx.t_wall0
        wall = t_batch / n
        system.stats.batch_wall_latencies.append(t_batch)
        system.stats.wall_latencies[-n:] = [wall] * n
        for s in ctx.states:
            s.result.wall_latency = wall


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


DEFAULT_STAGES = (EmbedStage, ScheduleStage, RetrieveStage, ScoreStage,
                  PlanStage, GenerateStage, ArchiveStage, FinishStage)


class ServePipeline:
    """Ordered stage list + the micro-batch driver.

    ``run`` admits the batch (ticks the system clock, builds one
    :class:`RequestState` per request), pushes the whole batch through
    every stage in order, and returns the states with ``result`` set.

    Timing contract: every state records ``admitted_at`` (pipeline entry)
    and ``stage_ts[name]`` (stage end) on the ``time.perf_counter`` clock,
    so per-stage wall times are real measurements, not the batch-amortised
    share.  After the last stage the driver back-fills each result's
    ``stage_walls`` (per-stage durations), ``wall_total`` (admission to
    Finish), and — when the caller supplied ``submitted_ats`` on the same
    clock — ``queue_delay`` (submission to admission).  Stages run at
    batch granularity, so batch members share stage boundaries; what is
    per-request is the existence of the full timestamp trail (coalesced
    duplicates included) and the queue delay.
    """

    def __init__(self, stages: Optional[Sequence] = None):
        self.stages = list(stages) if stages is not None else \
            [cls() for cls in DEFAULT_STAGES]

    @property
    def stage_names(self) -> List[str]:
        return [st.name for st in self.stages]

    def run(self, system, prompts: Sequence[str], *,
            seeds: Optional[Sequence[int]] = None,
            quality_tiers: Optional[Sequence[bool]] = None,
            submitted_ats: Optional[Sequence[float]] = None,
            ) -> List[RequestState]:
        n = len(prompts)
        if n == 0:
            return []
        t0 = time.perf_counter()
        seeds = list(seeds) if seeds is not None else [0] * n
        tiers = (list(quality_tiers) if quality_tiers is not None
                 else [False] * n)
        subs = (list(submitted_ats) if submitted_ats is not None
                else [None] * n)
        states = [RequestState(index=i, raw_prompt=str(p), prompt=str(p),
                               seed=seeds[i], quality_tier=tiers[i],
                               clock=system.clock + i + 1,
                               submitted_at=subs[i], admitted_at=t0)
                  for i, p in enumerate(prompts)]
        system.clock += n
        ctx = BatchContext(system=system, states=states, t_wall0=t0)
        for stage in self.stages:
            stage.run(ctx)
            ts = time.perf_counter()
            for s in states:
                s.stage_ts[stage.name] = ts
        # back-fill per-request timing onto the finished results
        last = self.stages[-1].name
        for s in states:
            if s.result is None:       # custom stage list without a Finish
                continue
            prev = t0
            walls: Dict[str, float] = {}
            for name in self.stage_names:
                walls[name] = s.stage_ts[name] - prev
                prev = s.stage_ts[name]
            s.result.stage_walls = walls
            s.result.wall_total = s.stage_ts[last] - s.admitted_at
            if s.submitted_at is not None:
                s.result.queue_delay = s.admitted_at - s.submitted_at
        return states

    # -- step-level split: admit now, generate over many boundaries, -----------
    #    finalize per slot in submission order

    def _stage_index(self, name: str) -> int:
        for i, st in enumerate(self.stages):
            if st.name == name:
                return i
        raise ValueError(
            f"stage {name!r} not in pipeline {self.stage_names} — the "
            "step-level split needs the default Generate/Archive/Finish "
            "stage shape")

    def run_admission(self, system, prompts: Sequence[str], *,
                      seeds: Optional[Sequence[int]] = None,
                      quality_tiers: Optional[Sequence[bool]] = None,
                      submitted_ats: Optional[Sequence[float]] = None,
                      inflight: Optional[List[Tuple[np.ndarray, int]]] = None,
                      ) -> List[RequestState]:
        """Run every stage BEFORE Generate (Embed..Plan) for a fresh
        admission group and return the planned states.

        This is the front half of :meth:`run` for the step-level serving
        engine: each state leaves with its ``plan`` set (clock ticked,
        Embed..Plan timestamps stamped) but no image/result — generation
        happens over many step boundaries in the caller's slot engine, and
        Archive/Finish land per slot via :meth:`finalize`.  ``inflight``
        seeds the Plan stage's coalescing set with earlier unfinalized gen
        requests (see :class:`BatchContext`)."""
        n = len(prompts)
        if n == 0:
            return []
        gen_i = self._stage_index("Generate")
        t0 = time.perf_counter()
        seeds = list(seeds) if seeds is not None else [0] * n
        tiers = (list(quality_tiers) if quality_tiers is not None
                 else [False] * n)
        subs = (list(submitted_ats) if submitted_ats is not None
                else [None] * n)
        states = [RequestState(index=i, raw_prompt=str(p), prompt=str(p),
                               seed=seeds[i], quality_tier=tiers[i],
                               clock=system.clock + i + 1,
                               submitted_at=subs[i], admitted_at=t0)
                  for i, p in enumerate(prompts)]
        system.clock += n
        ctx = BatchContext(system=system, states=states, t_wall0=t0,
                           inflight=inflight)
        for stage in self.stages[:gen_i]:
            stage.run(ctx)
            ts = time.perf_counter()
            for s in states:
                s.stage_ts[stage.name] = ts
        return states

    def finalize(self, system, state: RequestState) -> RequestState:
        """Run Archive + Finish for ONE retired request (the back half of
        the step-level split) and back-fill its per-request timing.

        The caller must have set ``state.image`` for gen plans (the slot
        engine's decode) and resolved negative alias targets into
        ``history`` plans.  A singleton batch has no interior maintenance
        boundary, so the Archive stage lands the blob/VDB insert eagerly
        and the Finish stage sweeps at the exact request-count crossing —
        calling this in submission order reproduces the sequential loop's
        (archive, sweep) sequence exactly.

        Timing is stamped PER SLOT, never per group: Embed..Plan carry the
        admission-time stamps, Generate the retirement stamp (filled at
        finalize start if the driver didn't reach it — cached/history/alias
        plans), Archive/Finish land here, and ``stage_walls`` /
        ``wall_total`` / ``queue_delay`` are derived from this slot's own
        trail — retirement order never smears one slot's walls onto
        another's."""
        arch_i = self._stage_index("Archive")
        t0 = time.perf_counter()
        for name in self.stage_names[:arch_i]:
            state.stage_ts.setdefault(name, t0)
        ctx = BatchContext(system=system, states=[state], t_wall0=t0)
        for stage in self.stages[arch_i:]:
            stage.run(ctx)
            ts = time.perf_counter()
            state.stage_ts[stage.name] = ts
        if state.result is not None:
            prev = state.admitted_at
            walls: Dict[str, float] = {}
            for name in self.stage_names:
                walls[name] = state.stage_ts[name] - prev
                prev = state.stage_ts[name]
            state.result.stage_walls = walls
            state.result.wall_total = (state.stage_ts[self.stages[-1].name]
                                       - state.admitted_at)
            if state.submitted_at is not None:
                state.result.queue_delay = state.admitted_at - state.submitted_at
        return state
