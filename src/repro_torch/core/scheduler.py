"""Request scheduler (paper §IV-E) — centroid and score-aware routing.

Routes each request to an edge node, in one of two modes:

* ``"centroid"`` — the paper's Eq. 6 baseline: route to the node whose
  VDB's mean embedding (the "node representation vector") is most
  cosine-similar to the prompt embedding.  The centroid is a coarse
  partition proxy: it says what a node's cache is ABOUT, not whether it
  actually holds a good reference for THIS prompt.
* ``"score"`` — route on the node's TRUE best match: the serve pipeline
  hands :meth:`RequestScheduler.schedule_batch` a ``(batch, nodes)``
  matrix of per-node best composite (Eq. 7) scores from ONE cluster-wide
  device scan (``ClusterIndex.search_cluster_nodes``), and the routing
  utility blends that best-match score with a small centroid-affinity
  prior (keeps novel prompts clustering semantically, so caches stay
  skew-partitioned), the queue-depth load penalty, and an
  expected-latency term from the Eq. 8 latency model (slow nodes pay
  for the steps their best match would still require).  This mirrors
  how Approximate Caching (NIRVANA) selects references by actual
  retrieval hit quality rather than partition proxies.

Both modes share the paper's two fast paths:

* **historical query cache** — near-duplicate prompts (cosine above
  ``dedup_threshold``) return the previously generated image directly,
  skipping scheduling AND VDB retrieval;
* **quality-aware priority scheduling** — repeated prompts from
  quality-tier users are pinned to the fastest node and forced through the
  full text-to-image path for maximum quality.

The scheduler also load-balances: the routing utility is penalised by each
node's queue depth so a hot cluster does not starve (the paper's async task
queue serves the same purpose).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.vdb import VectorDB
from repro_torch.utils import l2n


class UnknownNodeError(ValueError):
    """A node index outside the fleet was passed to a scheduler/fleet
    operation (``mark_failed`` / ``fail_node`` / ``rejoin_node`` / ...).
    Raised instead of letting Python's negative indexing silently alias
    the LAST node — the bug class this error type exists to surface."""


@dataclass
class NodeHealth:
    """Per-node health state driving degraded-mode serving.

    ``ewma`` is an exponentially weighted success score in [0, 1]: every
    observed fault (transient backend error, stall, corrupt reference)
    decays it toward 0, every success pulls it back toward 1.  A
    fault-free node stays at EXACTLY 1.0 (``1 + a*(1-1) == 1``), so the
    routing penalty is exactly 0 and fault-free routing is bitwise
    unchanged.  The circuit breaker quarantines a node after
    ``breaker_threshold`` consecutive faults (``state="open"`` — treated
    like dead by routing while alternatives exist), then probes it back
    in after ``breaker_cooldown`` scheduling rounds (``"half_open"``:
    routable again, one success closes it, one fault reopens it)."""

    ewma: float = 1.0
    consecutive_faults: int = 0
    state: str = "closed"        # closed | open | half_open
    cooldown: int = 0            # scheduling rounds until open -> half_open


@dataclass
class NodeInfo:
    """Per-node scheduling state: relative denoise-step throughput
    (``speed``, the paper's heterogeneous RTX mix), current ``queue_depth``
    (the load-penalty input), liveness (``alive=False`` nodes are
    never routed to — see ``CacheGenius.fail_node``), and the fault
    ``health`` score / circuit-breaker state (see :class:`NodeHealth`)."""

    index: int
    speed: float = 1.0           # relative denoise-step throughput (RTX mix)
    queue_depth: int = 0
    alive: bool = True
    health: NodeHealth = field(default_factory=NodeHealth)


@dataclass
class ScheduleDecision:
    """One request's routing outcome.

    ``fast_path`` is ``None`` (normal retrieval path), ``"history"``
    (historical-query duplicate; ``history_payload`` is the blob id to
    return) or ``"priority"`` (quality-tier repeat pinned to the fastest
    node).  ``match_score`` carries the similarity the decision was based
    on: the history-cache cosine for history decisions, the centroid
    similarity minus load penalty in centroid mode, or the routed node's
    best composite (Eq. 7) score in score mode — PlanStage uses it to
    arbitrate history hits against in-flight batch members."""

    node: int
    fast_path: Optional[str] = None      # None | "history" | "priority"
    history_payload: Optional[int] = None
    match_score: float = 0.0


@dataclass
class RequestScheduler:
    """Batch-first request router (see module docstring for the two
    routing modes and the fast paths).

    Weights of the score-mode routing utility (all applied to scores on
    the Eq. 7 [0, 1] scale):

    * ``balance_weight`` — per-queued-request penalty (both modes);
    * ``affinity_weight`` — centroid-similarity prior blended into score
      mode so novel prompts (no meaningful best match anywhere) still
      cluster semantically instead of all chasing the fastest node;
    * ``latency_weight`` — penalty per unit of expected Eq. 8 latency
      (normalised by the full-generation latency at speed 1.0), from the
      route the node's best match would take on that node's speed.  Set
      by ``CacheGenius`` wiring ``policy``/``latency_model``; without
      them the term is skipped.
    """

    nodes: List[NodeInfo]
    dedup_threshold: float = 0.97
    balance_weight: float = 0.02
    history_capacity: int = 4096
    affinity_weight: float = 0.10
    latency_weight: float = 0.05
    # health-aware degraded-mode serving (see NodeHealth): EWMA decay per
    # observation, routing penalty per unit of lost health, consecutive
    # faults before the breaker opens, scheduling rounds before probing
    health_alpha: float = 0.25
    health_weight: float = 0.20
    breaker_threshold: int = 3
    breaker_cooldown: int = 8
    policy: Optional[object] = None          # GenerationPolicy (score mode)
    latency_model: Optional[object] = None   # LatencyModel (score mode)
    _hist_vecs: np.ndarray = field(default=None, repr=False)  # type: ignore
    _hist_payloads: List[int] = field(default_factory=list, repr=False)
    _hist_hits: int = 0
    _prompt_counts: Dict[int, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._hist_vecs = np.zeros((0, 512), np.float32)

    # -- node representation vectors ----------------------------------------

    @staticmethod
    def node_vectors(dbs: Sequence[VectorDB]) -> np.ndarray:
        """L2-normalised node representation vectors (Eq. 6).

        ``VectorDB.centroid`` is served from a running sum/count
        maintained on every mutation, so building the representation
        matrix is O(nodes·dim) per micro-batch — NOT an
        O(capacity·dim) slab reduction per node (``ClusterIndex
        .node_vectors`` reads the same cached centroids)."""
        vecs = np.stack([db.centroid() for db in dbs])
        n = np.linalg.norm(vecs, axis=-1, keepdims=True)
        return vecs / np.maximum(n, 1e-12)

    # -- main entry -----------------------------------------------------------

    def schedule(self, prompt_vec: np.ndarray, dbs: Sequence[VectorDB], *,
                 quality_tier: bool = False, prompt_key: Optional[int] = None,
                 ) -> ScheduleDecision:
        """Route ONE request (centroid mode only — the scalar legacy
        surface; the serve pipeline routes whole micro-batches through
        :meth:`schedule_batch`, which is also where score-aware routing
        lives).  Unlike ``schedule_batch`` this mutates ``queue_depth``:
        callers pair it with :meth:`complete`."""
        # fast path 1: historical query cache
        hist = self._history_lookup(prompt_vec)
        if hist is not None:
            self._hist_hits += 1
            return ScheduleDecision(node=-1, fast_path="history",
                                    history_payload=hist, match_score=1.0)

        self._breaker_tick()
        # fast path 2: quality-aware priority scheduling for repeated prompts
        if prompt_key is not None:
            c = self._prompt_counts.get(prompt_key, 0)
            self._prompt_counts[prompt_key] = c + 1
            if quality_tier and c > 0:
                fastest = max(self._routable_nodes(), key=lambda n: n.speed)
                fastest.queue_depth += 1
                return ScheduleDecision(node=fastest.index, fast_path="priority")

        # Eq. 6: cosine(prompt, node representation), minus a load penalty
        reps = self.node_vectors(dbs)
        q = prompt_vec / max(np.linalg.norm(prompt_vec), 1e-12)
        sims = reps @ q
        routable = {n.index for n in self._routable_nodes()}
        for n in self.nodes:
            if n.index not in routable:
                sims[n.index] = -np.inf
            else:
                sims[n.index] -= self.balance_weight * n.queue_depth
                pen = self.health_weight * (1.0 - n.health.ewma)
                if pen:
                    sims[n.index] -= pen
        node = int(np.argmax(sims))
        self.nodes[node].queue_depth += 1
        return ScheduleDecision(node=node, match_score=float(sims[node]))

    def schedule_batch(self, prompt_vecs: np.ndarray, dbs: Sequence[VectorDB],
                       *, quality_tiers: Optional[Sequence[bool]] = None,
                       prompt_keys: Optional[Sequence[Optional[int]]] = None,
                       node_scores: Optional[np.ndarray] = None,
                       ) -> List[ScheduleDecision]:
        """Embed-and-route a whole micro-batch in one shot.

        The expensive vector math is amortised: ONE matmul against the
        historical-query cache, ONE node-representation build, ONE
        similarity matmul — then the per-request fast-path / priority /
        load logic runs over the precomputed rows in submission order,
        mutating ``_prompt_counts`` exactly like sequential calls.

        ``node_scores`` switches routing to SCORE mode: a ``(b, nodes)``
        matrix of each request's best composite (Eq. 7) match on every
        node — produced by the Schedule stage from ONE cluster-wide
        ``ClusterIndex.search_cluster_nodes`` scan (empty nodes = 0.0).
        The routing utility becomes ``best_match + affinity_weight *
        centroid_sim - balance_weight * queue_depth - latency_weight *
        expected_latency`` (see :meth:`_score_utilities`); ``None`` keeps
        the Eq. 6 centroid-only baseline.  Fast paths are identical in
        both modes.

        Batch semantics: the micro-batch is treated as scheduled-and-
        completed atomically, so queue depths are read (for the load
        penalty) but not left incremented — mirroring the sequential
        serve loop, where every request completes before the next one
        schedules.  History decisions carry the true match similarity in
        ``match_score`` so callers can arbitrate against in-flight
        (not-yet-archived) batch members.
        """
        self._breaker_tick()
        P = np.atleast_2d(np.asarray(prompt_vecs, np.float32))
        b = P.shape[0]
        tiers = list(quality_tiers) if quality_tiers is not None else [False] * b
        keys = list(prompt_keys) if prompt_keys is not None else [None] * b
        Qn = l2n(P)
        hist_sims = (Qn @ self._hist_vecs.T
                     if self._hist_vecs.shape[0] else None)      # (b, H)
        reps = self.node_vectors(dbs)                            # built once
        base_sims = Qn @ reps.T                                  # (b, N)
        lat_full = self._full_gen_latency()                      # hoisted
        decisions: List[ScheduleDecision] = []
        for i in range(b):
            # fast path 1: historical query cache
            if hist_sims is not None:
                j = int(np.argmax(hist_sims[i]))
                if hist_sims[i, j] >= self.dedup_threshold:
                    self._hist_hits += 1
                    decisions.append(ScheduleDecision(
                        node=-1, fast_path="history",
                        history_payload=self._hist_payloads[j],
                        match_score=float(hist_sims[i, j])))
                    continue
            # fast path 2: quality-aware priority for repeated prompts
            if keys[i] is not None:
                c = self._prompt_counts.get(keys[i], 0)
                self._prompt_counts[keys[i]] = c + 1
                if tiers[i] and c > 0:
                    fastest = max(self._routable_nodes(),
                                  key=lambda n: n.speed)
                    decisions.append(ScheduleDecision(node=fastest.index,
                                                      fast_path="priority"))
                    continue
            if node_scores is not None:          # score-aware routing
                util = self._score_utilities(node_scores[i], base_sims[i],
                                             lat_full)
                node = int(np.argmax(util))
                decisions.append(ScheduleDecision(
                    node=node, match_score=float(node_scores[i][node])))
                continue
            sims = base_sims[i].copy()
            routable = {n.index for n in self._routable_nodes()}
            for n in self.nodes:
                if n.index not in routable:
                    sims[n.index] = -np.inf
                else:
                    sims[n.index] -= self.balance_weight * n.queue_depth
                    pen = self.health_weight * (1.0 - n.health.ewma)
                    if pen:
                        sims[n.index] -= pen
            node = int(np.argmax(sims))
            decisions.append(ScheduleDecision(node=node,
                                              match_score=float(sims[node])))
        return decisions

    def _full_gen_latency(self) -> Optional[float]:
        """Speed-1.0 full-generation Eq. 8 latency — the normaliser of
        the score-mode latency penalty, constant per batch (``None``
        disables the term when policy/latency_model are unwired)."""
        if self.policy is None or self.latency_model is None:
            return None
        from repro_torch.core.policy import Route
        return self.latency_model.latency(
            Route.TXT2IMG, self.policy.steps_full, node_speed=1.0)

    def _score_utilities(self, best_row: np.ndarray,
                         centroid_row: np.ndarray,
                         lat_full: Optional[float]) -> np.ndarray:
        """Score-mode routing utility for one request.

        ``best_row`` — best composite (Eq. 7) match per node; dominant
        term, so a node that can actually serve a HIT_RETURN/IMG2IMG
        reference wins.  ``centroid_row`` — Eq. 6 centroid similarities;
        the ``affinity_weight`` prior keeps novel prompts (best ~0
        everywhere) semantically clustered.  Queue depth pays
        ``balance_weight`` each; the latency term charges each node the
        Eq. 8 latency its best match would incur there (route thresholds
        from ``policy``, per-step time scaled by node speed), normalised
        by ``lat_full`` (:meth:`_full_gen_latency`).  Dead nodes are
        -inf.
        """
        util = (np.asarray(best_row, np.float64)
                + self.affinity_weight * np.asarray(centroid_row, np.float64))
        routable = {n.index for n in self._routable_nodes()}
        for n in self.nodes:
            if n.index not in routable:
                util[n.index] = -np.inf
                continue
            util[n.index] -= self.balance_weight * n.queue_depth
            pen = self.health_weight * (1.0 - n.health.ewma)
            if pen:
                util[n.index] -= pen
            if lat_full:
                route = self.policy.route(float(best_row[n.index]))
                lat = self.latency_model.latency(
                    route, self.policy.steps_for(route), node_speed=n.speed)
                util[n.index] -= self.latency_weight * lat / lat_full
        return util

    def complete(self, node: int) -> None:
        """Release the queue slot a prior ``schedule()`` call claimed.

        Strictly paired with the increment: history hits (node == -1) and
        out-of-range nodes are no-ops, and an underflow — ``complete``
        without a matching ``schedule`` increment — warns and leaves the
        depth at 0 instead of silently clamping (a clamp here masked
        double-release bugs)."""
        if not (0 <= node < len(self.nodes)):
            return
        if self.nodes[node].queue_depth <= 0:
            warnings.warn(
                f"queue-depth underflow on node {node}: complete() without "
                "a matching schedule() increment", RuntimeWarning)
            return
        self.nodes[node].queue_depth -= 1

    # -- history cache --------------------------------------------------------

    def _history_lookup(self, vec: np.ndarray) -> Optional[int]:
        if self._hist_vecs.shape[0] == 0:
            return None
        q = vec / max(np.linalg.norm(vec), 1e-12)
        sims = self._hist_vecs @ q
        i = int(np.argmax(sims))
        if sims[i] >= self.dedup_threshold:
            return self._hist_payloads[i]
        return None

    def count_history_hit(self) -> None:
        """Book a history hit resolved outside `schedule` — the batched
        serve path detects near-duplicates of *in-flight* batch members
        (whose results are not yet archived) and must keep the counter in
        lockstep with the sequential loop."""
        self._hist_hits += 1

    def uncount_prompt(self, prompt_key: int) -> None:
        """Roll back one `_prompt_counts` increment.  Sequential serve
        never counts a request that history-hits; when the batched path
        retroactively turns a scheduled request into an in-flight history
        hit, it undoes the count `schedule_batch` already applied."""
        c = self._prompt_counts.get(prompt_key)
        if c is not None:
            self._prompt_counts[prompt_key] = max(0, c - 1)

    def record_result(self, prompt_vec: np.ndarray, payload_id: int) -> None:
        q = prompt_vec / max(np.linalg.norm(prompt_vec), 1e-12)
        self._hist_vecs = np.concatenate([self._hist_vecs, q[None]])[-self.history_capacity:]
        self._hist_payloads = (self._hist_payloads + [payload_id])[-self.history_capacity:]

    def invalidate_payloads(self, payload_ids) -> None:
        """Cache-maintenance consistency (paper §IV-G: image files are
        removed synchronously): drop history entries whose blobs were
        evicted, else a history hit would dereference a deleted image."""
        doomed = set(int(p) for p in payload_ids)
        if not doomed or self._hist_vecs.shape[0] == 0:
            return
        keep = [i for i, p in enumerate(self._hist_payloads)
                if p not in doomed]
        self._hist_vecs = self._hist_vecs[keep]
        self._hist_payloads = [self._hist_payloads[i] for i in keep]

    # -- health / circuit breaker ------------------------------------------------

    def _check_node(self, node: int) -> None:
        if not (0 <= node < len(self.nodes)):
            raise UnknownNodeError(
                f"unknown node index {node} (fleet has {len(self.nodes)} "
                f"nodes; negative indices are rejected, not aliased)")

    def observe_fault(self, node: int, kind: str = "transient") -> None:
        """Record one fault observation against ``node`` (transient
        backend error, stall, corrupt blob).  Decays the health EWMA and
        advances the circuit breaker: ``breaker_threshold`` consecutive
        faults — or any fault while half-open — open it."""
        self._check_node(node)
        h = self.nodes[node].health
        h.ewma = (1.0 - self.health_alpha) * h.ewma
        h.consecutive_faults += 1
        if (h.state == "half_open"
                or h.consecutive_faults >= self.breaker_threshold):
            h.state = "open"
            h.cooldown = self.breaker_cooldown
            h.consecutive_faults = 0

    def observe_ok(self, node: int) -> None:
        """Record one successful serve: health recovers toward 1.0, the
        consecutive-fault streak resets, and a half-open breaker closes
        (the probe succeeded)."""
        self._check_node(node)
        h = self.nodes[node].health
        h.ewma += self.health_alpha * (1.0 - h.ewma)
        h.consecutive_faults = 0
        if h.state == "half_open":
            h.state = "closed"

    def _breaker_tick(self) -> None:
        """One scheduling round: open breakers count down their cooldown
        and transition to half-open (routable again, one strike allowed)
        when it expires."""
        for n in self.nodes:
            h = n.health
            if h.state == "open":
                h.cooldown -= 1
                if h.cooldown <= 0:
                    h.state = "half_open"

    def _routable_nodes(self) -> List[NodeInfo]:
        """Alive nodes minus open-breaker quarantine, in fleet order (so
        tie-breaks match the pre-health router bit-for-bit).  If EVERY
        alive node is quarantined, degrade to all alive nodes — serving
        beats refusing.  No alive nodes at all is a hard error."""
        alive = [n for n in self.nodes if n.alive]
        if not alive:
            raise RuntimeError("no alive nodes to route to")
        routable = [n for n in alive if n.health.state != "open"]
        return routable or alive

    # -- failures / elasticity --------------------------------------------------

    def mark_failed(self, node: int) -> None:
        self._check_node(node)
        self.nodes[node].alive = False

    def mark_alive(self, node: int) -> None:
        """Rejoin a previously failed node: alive, empty queue, fresh
        health (speed is a property of the hardware and survives)."""
        self._check_node(node)
        n = self.nodes[node]
        n.alive = True
        n.queue_depth = 0
        n.health = NodeHealth()

    def add_node(self, *, speed: float = 1.0) -> int:
        """Register one fresh node (graceful join): it starts alive with
        an empty queue and competes for routing immediately — its empty
        cache means a ~zero centroid/best-match, so traffic shifts to it
        through the load-balance term first and semantically once
        archives land.  Returns the new node index."""
        idx = len(self.nodes)
        self.nodes.append(NodeInfo(idx, speed=speed))
        return idx

    @property
    def history_hits(self) -> int:
        return self._hist_hits
