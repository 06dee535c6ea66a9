"""Dispatcher: bridges the front-door queue to the step-group engine loop;
the port of the JAX package's ``repro/frontdoor/dispatcher.py``.

The serving engine is synchronous and batch-oriented: one
``ServingEngine.serve_group`` call runs one staged-pipeline pass (one set
of padded generation batches) to completion.  The dispatcher runs that loop
on a dedicated WORKER THREAD and, at every group boundary, admits the
fair-share head of the queue as the next group:

    submit (any thread / asyncio) ──> FrontDoorQueue ──┐
                                                       │ next_batch(max_batch)
          worker thread:  ... group N ──[boundary]─────┴─> group N+1 ...

Between groups the worker also applies queued CONTROL OPS — node
join/leave — so capacity changes are graceful by construction: routing
happens inside ``serve_batch`` at admission, so a node marked failed at a
boundary simply stops receiving new groups while every already-accepted
job still in the queue reroutes to the survivors.  Zero accepted jobs are
lost (``tests/test_frontdoor.py`` pins this).

SLA tiers map onto the scheduler's existing priority machinery here:
``premium`` (tier level 0) jobs run with ``quality_tier=True``, so
repeated premium prompts take the scheduler's ``fast_path="priority"``
pin-to-fastest-node path, exactly like the paper's quality-aware
priority scheduling.

On completion each job's image is ``put`` into the result store and the
job's handle resolves with the store reference + metadata; the
``ServeResult`` image pointer is dropped so finished pixels do not
accumulate in engine memory (the offload contract of
``repro_torch.frontdoor.results``).

On the card every kernel of a group launches from the worker thread.  A
new thread starts on device 0 and its default stream, so ``serve_group``
runs under ``torch.cuda.device`` of the backend's device (the fleet's
where the backend names none); the kernels' wrappers take their stream
from that device and build and load the libraries under a lock.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Callable, List, Optional

import torch

from repro_torch.core.pipeline import TransientBackendError
from repro_torch.frontdoor.queue import FrontDoorQueue, Job
from repro_torch.frontdoor.results import GatewayClosedError, ResultStore
from repro_torch.runtime.serving import Request, ServingEngine

__all__ = ["Dispatcher"]


class Dispatcher:
    """Worker-thread pump from a :class:`FrontDoorQueue` into a
    :class:`ServingEngine` (see the module docstring for the loop)."""

    def __init__(self, engine: ServingEngine, queue: FrontDoorQueue,
                 store: ResultStore, *,
                 clock: Callable[[], float] = time.perf_counter,
                 idle_wait: float = 0.005,
                 max_group_retries: int = 3,
                 retry_backoff: float = 0.01):
        self.engine = engine
        self.queue = queue
        self.store = store
        self.clock = clock
        self.idle_wait = idle_wait
        # transiently failed groups retry with doubling backoff before
        # the whole group is failed to its handles
        self.max_group_retries = int(max_group_retries)
        self.retry_backoff = float(retry_backoff)
        self.groups_served = 0
        self.jobs_served = 0
        self._control: List[Callable[[], None]] = []
        self._control_lock = threading.Lock()
        self._stop = threading.Event()
        self._drain_on_stop = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("dispatcher already started")
        self._thread = threading.Thread(target=self._run,
                                        name="frontdoor-dispatcher",
                                        daemon=True)
        self._thread.start()

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the worker.  ``drain=True`` (default) serves everything
        already accepted first — the graceful path; ``drain=False`` fails
        still-queued jobs with :class:`GatewayClosedError`.

        If ``timeout`` expires with the worker still alive, a
        ``RuntimeWarning`` is issued and the thread handle is KEPT (so
        ``running`` stays truthful and a later ``stop`` can join it) —
        earlier revisions dropped the handle silently, making hung
        shutdowns invisible."""
        self._drain_on_stop = drain
        self._stop.set()
        self.queue.kick()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                warnings.warn(
                    f"dispatcher worker did not stop within {timeout}s "
                    f"({len(self.queue)} jobs still queued); thread handle "
                    "kept — call stop() again to re-join",
                    RuntimeWarning, stacklevel=2)
                return
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- control ops (applied at the next group boundary) -------------------

    def leave_node(self, node: int) -> None:
        """Gracefully remove ``node`` from the fleet at the next group
        boundary: in-flight work finishes first, queued jobs reroute."""
        with self._control_lock:
            self._control.append(lambda: self.engine.fail_node(node))
        self._kick()

    def join_node(self, *, speed: float = 1.0,
                  capacity: Optional[int] = None) -> None:
        """Add a fresh node at the next group boundary (see
        ``ServingEngine.join_node``)."""
        with self._control_lock:
            self._control.append(
                lambda: self.engine.join_node(speed=speed,
                                              capacity=capacity))
        self._kick()

    def _kick(self) -> None:
        # wake the worker so a control op on an idle queue applies promptly
        self.queue.kick()

    def _apply_control(self) -> None:
        with self._control_lock:
            ops, self._control = self._control, []
        for op in ops:
            op()

    # -- the worker loop ----------------------------------------------------

    def _run(self) -> None:
        while True:
            self._apply_control()
            if self._stop.is_set():
                if not self._drain_on_stop or not len(self.queue):
                    break
            elif not len(self.queue):
                self.queue.wait_for_jobs(self.idle_wait)
                continue
            jobs = self.queue.next_batch(self.engine.max_batch,
                                         now=self.clock())
            if not jobs:
                continue
            self._serve_group(jobs)
        # anything still queued after a no-drain stop fails typed
        for job in self.queue.next_batch(len(self.queue) or 1,
                                         now=self.clock()):
            if job.handle is not None:
                job.handle._fail(GatewayClosedError(
                    f"gateway closed before job {job.job_id} was served"))

    def _serve_group(self, jobs: List[Job]) -> None:
        batch = [Request(j.prompt, j.seed,
                         quality_tier=(j.quality_tier
                                       if j.quality_tier is not None
                                       else self._is_priority(j)),
                         submitted_at=j.submitted_at,
                         tenant=j.tenant, tier=j.tier)
                 for j in jobs]
        backoff = self.retry_backoff
        attempt = 0
        while True:
            try:
                with self._device_scope():
                    completed = self.engine.serve_group(batch)
                break
            except TransientBackendError as exc:
                # transiently failed group: back off and retry (on top of
                # the Generate stage's own in-call retry budget)
                attempt += 1
                if attempt > self.max_group_retries:
                    for j in jobs:
                        if j.handle is not None:
                            j.handle._fail(exc)
                    return
                time.sleep(backoff)
                backoff *= 2.0
            except Exception as exc:             # fail the whole group
                for j in jobs:
                    if j.handle is not None:
                        j.handle._fail(exc)
                return
        done_at = self.clock()
        for job, comp in zip(jobs, completed):
            job.admitted_at = job.submitted_at + comp.queue_delay
            job.finished_at = done_at
            res = comp.result
            meta = {
                "tenant": job.tenant, "tier": job.tier,
                "effective_tier": job.effective_tier,
                "escalations": job.escalations,
                "route": res.fast_path or res.route.value,
                "node": res.node, "score": res.score,
                "queue_delay": comp.queue_delay,
                "wall_total": res.wall_total,
                "latency": res.latency,
            }
            ref = self.store.put(job.job_id, res.image, meta)
            res.image = None      # offloaded: the store owns the pixels now
            self.jobs_served += 1
            if job.handle is not None:
                job.handle._resolve(ref, meta)
        self.groups_served += 1

    def _device_scope(self):
        """The engine's card as the worker thread's current device; a
        CPU engine needs none."""
        system = self.engine.system
        dev = getattr(system.backend, "device", None)
        dev = torch.device(system.device if dev is None else dev)
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _is_priority(self, job: Job) -> bool:
        spec = self.queue.tiers.get(job.tier)
        return spec is not None and spec.level == 0
