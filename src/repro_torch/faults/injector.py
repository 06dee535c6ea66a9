"""Fault injector — applies a :class:`FaultSchedule` to a live fleet; the
port of the JAX package's ``repro/faults/injector.py``.

Wire-up (see ``repro_torch.launch.serve`` for the CLI form)::

    journals = attach_journals(system, "/tmp/journals")   # durability on
    injector = FaultInjector(system, schedule, journals=journals)
    engine.run(trace, on_step=injector.on_step, ...)      # either mode
    print(injector.report())

The injector owns three fault surfaces:

* the serving engine's ``on_step`` hook — crash/fail/stall/corrupt
  events fire at the injection boundary they are scripted for, and
  scheduled rejoins/unstalls land the boundary their countdown expires;
* a :class:`FlakyBackend` proxy swapped in as ``system.backend`` —
  transient events arm it to raise ``TransientBackendError`` from the
  next N generation calls (the retry machinery in
  ``GenerateStage``/``ServingEngine``/``Dispatcher`` absorbs them);
* the node journals (optional) — a crashed node with a journal rejoins
  via ``CacheJournal.replay`` + ``CacheGenius.rejoin_node`` (bitwise its
  pre-crash cache); without one it rejoins cold.

Every action is appended to ``self.log`` as ``(step, action, detail)``
so a chaos run is auditable after the fact; :meth:`report` summarises.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.journal import CacheJournal
from repro_torch.core.pipeline import TransientBackendError
from repro_torch.faults.schedule import FaultEvent, FaultSchedule

__all__ = ["FaultInjector", "FlakyBackend", "attach_journals"]


class FlakyBackend:
    """Transparent generation-backend proxy with an armable fault
    counter: while armed, the three batched generation entry points
    raise :class:`TransientBackendError` instead of generating (one
    charge per call).  Everything else — scalar entry points, latent
    archiving, ``make_slot_engine``, ``supports_latent_resume`` —
    delegates untouched, so a real accelerator backend keeps its own
    slot engine and compiled functions."""

    def __init__(self, inner):
        self._inner = inner
        self._armed = 0
        self.faults_injected = 0

    def arm(self, count: int = 1) -> None:
        """Fail the next ``count`` generation calls.  Saturating, not
        additive: two transient events with no backend call between them
        leave the counter at ``max`` of the two, so no single retried
        call ever faces more consecutive faults than one scripted event's
        ``count`` — which is what keeps scripted chaos inside the serving
        stack's ``transient_retries`` budget (zero accepted-job loss)."""
        self._armed = max(self._armed, int(count))

    def _maybe_fail(self) -> None:
        if self._armed > 0:
            self._armed -= 1
            self.faults_injected += 1
            raise TransientBackendError("injected transient backend fault")

    def txt2img_batch(self, *args, **kwargs):
        self._maybe_fail()
        return self._inner.txt2img_batch(*args, **kwargs)

    def img2img_batch(self, *args, **kwargs):
        self._maybe_fail()
        return self._inner.img2img_batch(*args, **kwargs)

    def resume_batch(self, *args, **kwargs):
        self._maybe_fail()
        return self._inner.resume_batch(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def attach_journals(system, root: str, *,
                    snapshot_every: int = 64) -> Dict[int, CacheJournal]:
    """One :class:`CacheJournal` per node under ``root/node<i>/``, bound
    to the node's ``VectorDB``.  A base snapshot is published immediately
    so pre-attach cache content (the corpus pre-population) is part of
    the durable state — the WAL only ever needs to cover mutations made
    AFTER attachment."""
    journals: Dict[int, CacheJournal] = {}
    for i, db in enumerate(system.dbs):
        j = CacheJournal(os.path.join(root, f"node{i}"),
                         snapshot_every=snapshot_every)
        db.attach_journal(j)
        j.snapshot()
        journals[i] = j
    return journals


class FaultInjector:
    """Applies a :class:`FaultSchedule` to ``system`` via ``on_step``.

    Constructing the injector swaps ``system.backend`` for a
    :class:`FlakyBackend` proxy (kept on ``self.backend``); pass
    ``journals`` (from :func:`attach_journals`) to give crashed nodes a
    durable rejoin path."""

    def __init__(self, system, schedule: FaultSchedule, *,
                 journals: Optional[Dict[int, CacheJournal]] = None):
        self.system = system
        self.schedule = schedule
        self.journals = dict(journals or {})
        self.backend = FlakyBackend(system.backend)
        system.backend = self.backend
        self.log: List[Tuple[int, str, str]] = []
        self._rejoin_at: Dict[int, List[int]] = {}        # step -> nodes
        self._unstall_at: Dict[int, List[Tuple[int, float]]] = {}
        self.steps_seen = 0

    # -- the hook -------------------------------------------------------------

    def on_step(self, step_no: int) -> None:
        """The serving engine's injection hook: settle due countdowns
        (rejoins, unstalls) first, then fire this boundary's events."""
        self.steps_seen = max(self.steps_seen, step_no + 1)
        for node in self._rejoin_at.pop(step_no, []):
            self._rejoin(node, step_no)
        for node, speed in self._unstall_at.pop(step_no, []):
            self.system.scheduler.nodes[node].speed = speed
            self.log.append((step_no, "unstall", f"node{node}"))
        for e in self.schedule.at(step_no):
            self._fire(e, step_no)

    def finish(self) -> None:
        """Settle countdowns still pending when the trace ends (a rejoin
        scheduled past the last step must still happen, or the recovery
        benchmarks would compare against a half-dead fleet)."""
        for step in sorted(self._rejoin_at):
            for node in self._rejoin_at[step]:
                self._rejoin(node, step)
        self._rejoin_at.clear()
        for step in sorted(self._unstall_at):
            for node, speed in self._unstall_at[step]:
                self.system.scheduler.nodes[node].speed = speed
                self.log.append((step, "unstall", f"node{node}"))
        self._unstall_at.clear()

    # -- event handlers -------------------------------------------------------

    def _fire(self, e: FaultEvent, step_no: int) -> None:
        if e.kind == "crash":
            self._crash(e, step_no)
        elif e.kind == "fail":
            if self.system.scheduler.nodes[e.node].alive:
                self.system.fail_node(e.node)
                self.log.append((step_no, "fail", f"node{e.node}"))
            else:
                self.log.append((step_no, "skip-fail",
                                 f"node{e.node} already dead"))
        elif e.kind == "transient":
            self.backend.arm(e.count)
            self.log.append((step_no, "transient", f"arm {e.count}"))
        elif e.kind == "corrupt":
            self._corrupt(e, step_no)
        elif e.kind == "stall":
            n = self.system.scheduler.nodes[e.node]
            self._unstall_at.setdefault(step_no + max(e.duration, 1),
                                        []).append((e.node, n.speed))
            n.speed *= e.factor
            self.log.append((step_no, "stall",
                             f"node{e.node} x{e.factor} "
                             f"for {max(e.duration, 1)}"))

    def _crash(self, e: FaultEvent, step_no: int) -> None:
        sched = self.system.scheduler
        if not sched.nodes[e.node].alive:
            self.log.append((step_no, "skip-crash",
                             f"node{e.node} already dead"))
            return
        if sum(n.alive for n in sched.nodes) == 1:
            self.log.append((step_no, "skip-crash",
                             f"node{e.node} is the last alive node"))
            return
        self.system.crash_node(e.node)
        self.log.append((step_no, "crash", f"node{e.node}"))
        if e.duration > 0:
            self._rejoin_at.setdefault(step_no + e.duration,
                                       []).append(e.node)

    def _corrupt(self, e: FaultEvent, step_no: int) -> None:
        store = self.system.blob_store
        bids = sorted(store._blobs)
        if not bids:
            self.log.append((step_no, "skip-corrupt", "empty blob store"))
            return
        rng = self.schedule.rng(step_no)
        k = max(1, int(round(len(bids) * e.frac)))
        picks = rng.choice(np.asarray(bids), size=min(k, len(bids)),
                           replace=False)
        for bid in picks:
            store.corrupt(int(bid), rng)
        self.log.append((step_no, "corrupt", f"{len(picks)} blobs"))

    def _rejoin(self, node: int, step_no: int) -> None:
        if self.system.scheduler.nodes[node].alive:
            self.log.append((step_no, "skip-rejoin",
                             f"node{node} already alive"))
            return
        j = self.journals.get(node)
        cur = self.system.dbs[node]
        if j is not None:
            db = j.replay(cur.dim, cur.capacity, name=cur.name,
                          use_pallas=cur.use_pallas, device=cur.device)
            db.attach_journal(j)
            self.system.rejoin_node(node, db)
            self.log.append((step_no, "rejoin-journaled",
                             f"node{node} ({db.size} entries)"))
        else:
            self.system.rejoin_node(node)
            self.log.append((step_no, "rejoin-cold", f"node{node}"))

    # -- summary --------------------------------------------------------------

    def report(self) -> Dict[str, object]:
        """Audit summary of the run: what fired, what the system absorbed."""
        counts: Dict[str, int] = {}
        for _, action, _ in self.log:
            counts[action] = counts.get(action, 0) + 1
        stats = self.system.stats
        return {
            "steps_seen": self.steps_seen,
            "actions": counts,
            "faults_injected": self.backend.faults_injected,
            "corrupt_hits": stats.corrupt_hits,
            "degraded_serves": stats.degraded_serves,
            "transient_retries": stats.transient_retries,
            "log": list(self.log),
        }
