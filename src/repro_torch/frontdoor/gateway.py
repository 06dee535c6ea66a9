"""Gateway: the client-facing async front door over the serving engine; the
port of the JAX package's ``repro/frontdoor/gateway.py``.

This is the production shape of the paper's §V deployment — what turns
the repo's trace generators into "one client among many".  A
:class:`Gateway` owns the three front-door pieces and wires them to a
``ServingEngine``:

    clients ──submit()──> FrontDoorQueue ──Dispatcher (worker thread)──>
        ServingEngine.serve_group ──> ResultStore ──> ResultHandle

* ``submit`` runs admission control synchronously (token-bucket quota +
  global backpressure bound, both typed errors) and returns a
  :class:`ResultHandle` immediately — clients ``await
  handle.wait_async()`` (asyncio) or ``handle.wait()`` (threads) and
  fetch pixels from the result store on demand.  No HTTP framework is
  required: the gateway IS the API surface, stdlib-only, and a FastAPI/
  aiohttp wrapper would be a ~20-line adapter over ``submit``.
* SLA tiers (``premium``/``standard``/``batch`` by default) give strict
  dequeue priority with deadline-based escalation; per-tenant token
  buckets bound each tenant's accepted rate; weighted fair share keeps
  any one tenant from starving the rest (all in
  ``repro_torch.frontdoor.queue``).
* ``join_node`` / ``leave_node`` change fleet capacity mid-run,
  gracefully: ops apply at the next step-group boundary, in-queue jobs
  reroute, nothing accepted is lost.

Everything is wall-clock (``time.perf_counter``): unlike
``ServingEngine.run``'s virtual timeline, concurrent clients experience
real queueing against real service walls.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.frontdoor.dispatcher import Dispatcher
from repro_torch.frontdoor.queue import (DEFAULT_TIERS, FrontDoorQueue,
                                         Job, TierSpec, TokenBucket)
from repro_torch.frontdoor.results import (MemoryResultStore, ResultHandle,
                                           ResultStore)
from repro_torch.runtime.serving import ServingEngine, tenant_tier_stats

__all__ = ["Gateway"]


class Gateway:
    """Async multi-tenant serving gateway (see the module docstring).

    ``quotas`` maps tenant -> ``(rate, burst)`` token-bucket parameters
    (tenants without an entry are unmetered); ``tenant_weights`` sets
    fair-share weights (default 1.0 each).  ``store=None`` uses the
    in-memory result store; pass a ``FileResultStore`` to offload
    finished images to disk.
    """

    def __init__(self, engine: ServingEngine, *,
                 tiers: Sequence[TierSpec] = DEFAULT_TIERS,
                 max_depth: int = 256,
                 quotas: Optional[Dict[str, Tuple[float, float]]] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 fair: bool = True,
                 store: Optional[ResultStore] = None):
        self.engine = engine
        self.store: ResultStore = store if store is not None \
            else MemoryResultStore()
        buckets = {t: TokenBucket(rate, burst)
                   for t, (rate, burst) in (quotas or {}).items()}
        self.queue = FrontDoorQueue(tiers=tiers, max_depth=max_depth,
                                    quotas=buckets,
                                    tenant_weights=tenant_weights,
                                    fair=fair)
        self.dispatcher = Dispatcher(engine, self.queue, self.store)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Gateway":
        """Start the dispatcher worker.  Jobs may be submitted before
        ``start`` — they queue up and the first group admits them."""
        self.dispatcher.start()
        return self

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop serving.  ``drain=True`` finishes every accepted job
        first; ``drain=False`` fails still-queued handles with
        ``GatewayClosedError``."""
        self.dispatcher.stop(drain=drain, timeout=timeout)

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=not any(exc))

    # -- the client surface -------------------------------------------------

    def submit(self, prompt: str, *, tenant: str = "default",
               tier: str = "standard", seed: int = 0,
               quality_tier: Optional[bool] = None) -> ResultHandle:
        """Admission-control one request; returns its completion handle.

        Raises ``ValueError`` (unknown tier), ``QuotaExceededError``
        (tenant over quota; carries ``retry_after``) or
        ``BackpressureError`` (queue full) — the typed rejections clients
        key their backoff on.  ``quality_tier=None`` derives the
        scheduler priority flag from the tier (premium ⇒ True).
        """
        job = Job(tenant=tenant, tier=tier, prompt=prompt, seed=seed,
                  quality_tier=quality_tier)
        handle = ResultHandle(job.job_id, self.store)
        job.handle = handle
        self.queue.submit(job, now=time.perf_counter())
        return handle

    async def submit_async(self, prompt: str, **kw) -> ResultHandle:
        """`submit` for asyncio clients.  Admission control is pure
        in-memory bookkeeping (no blocking I/O), so it runs inline on
        the event loop."""
        return self.submit(prompt, **kw)

    # -- capacity control ---------------------------------------------------

    def leave_node(self, node: int) -> None:
        """Gracefully drain ``node`` out of the fleet (next boundary)."""
        self.dispatcher.leave_node(node)

    def join_node(self, *, speed: float = 1.0,
                  capacity: Optional[int] = None) -> None:
        """Grow the fleet by one fresh node (next boundary)."""
        self.dispatcher.join_node(speed=speed, capacity=capacity)

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict:
        """Operational snapshot: queue depth + admission tallies, groups
        served, and per-(tenant, tier) queue-delay / wall-latency
        percentiles over everything completed so far."""
        qs = self.queue.stats
        return {
            "queued": len(self.queue),
            "accepted": qs.accepted,
            "dispatched": qs.dispatched,
            "rejected_quota": qs.rejected_quota,
            "rejected_backpressure": qs.rejected_backpressure,
            "escalations": qs.escalations,
            "accepted_by_tenant": dict(qs.accepted_by_tenant),
            "rejected_by_tenant": dict(qs.rejected_by_tenant),
            "groups_served": self.dispatcher.groups_served,
            "jobs_served": self.dispatcher.jobs_served,
            "per_tenant_tier": tenant_tier_stats(self.engine.completed),
            "stored_results": len(self.store),
        }
