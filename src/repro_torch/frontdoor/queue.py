"""SLA-tier job queue: per-tenant quotas, weighted fair share, escalation.

This is the deterministic core of the front door (the asyncio gateway and
the worker-thread dispatcher are thin wrappers around it).  One queue
holds every accepted-but-not-yet-admitted job, organised as a FIFO deque
per (tier, tenant):

* **SLA tiers** — strict priority levels (:data:`DEFAULT_TIERS`:
  ``premium`` > ``standard`` > ``batch``), each with an SLA deadline.
  :meth:`FrontDoorQueue.next_batch` always serves the highest non-empty
  tier first, so one group boundary is the longest a premium job ever
  waits behind batch traffic.
* **Deadline-based escalation** — a job that has waited past its tier's
  ``escalate_after`` is promoted one level (joining the tail of the
  higher tier's per-tenant deque), so lower tiers degrade to
  "eventually served" instead of "starved" under sustained premium
  overload.  ``math.inf`` disables escalation for a tier.
* **Weighted fair share across tenants** — within the chosen tier,
  tenants are picked by start-time fair queueing: each tenant carries a
  virtual time advanced by ``1 / weight`` per dequeued job, and the
  lowest virtual time (ties broken by tenant name) goes first.  A tenant
  that floods the queue only advances its own virtual time, so a quiet
  tenant's next job is always near the front — the no-starvation
  property ``tests/test_frontdoor.py`` pins.
* **Admission control** — :meth:`FrontDoorQueue.submit` REJECTS instead
  of buffering unboundedly: a per-tenant token bucket (rate + burst)
  raises :class:`QuotaExceededError` when the tenant is over quota, and
  a global ``max_depth`` bound raises :class:`BackpressureError` when
  the whole queue is full.  Both are typed so gateway clients can
  distinguish "you specifically are over quota (retry after
  ``retry_after``)" from "the system is saturated".

All methods take an explicit ``now`` (seconds on any monotonic clock),
which keeps every policy decision replayable in tests; the queue is
internally locked so the gateway (submitting) and the dispatcher worker
thread (dequeuing) can share it.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

__all__ = ["BackpressureError", "DEFAULT_TIERS", "FrontDoorQueue", "Job",
           "QuotaExceededError", "TierSpec", "TokenBucket"]


# ---------------------------------------------------------------------------
# typed backpressure errors
# ---------------------------------------------------------------------------


class BackpressureError(RuntimeError):
    """The queue refused a job because the system is saturated.

    Carries enough context for a client to back off sensibly: the
    ``tenant``/``tier`` it tried to submit to, the queue ``depth`` at
    rejection, and the configured ``bound``.
    """

    def __init__(self, msg: str, *, tenant: str, tier: str,
                 depth: int, bound: int):
        super().__init__(msg)
        self.tenant = tenant
        self.tier = tier
        self.depth = depth
        self.bound = bound


class QuotaExceededError(BackpressureError):
    """The TENANT is over its token-bucket quota (the system may be
    idle).  ``retry_after`` is the seconds until the bucket refills one
    token — the natural client back-off interval."""

    def __init__(self, msg: str, *, tenant: str, tier: str, depth: int,
                 bound: int, retry_after: float):
        super().__init__(msg, tenant=tenant, tier=tier, depth=depth,
                         bound=bound)
        self.retry_after = retry_after


# ---------------------------------------------------------------------------
# tiers and quotas
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TierSpec:
    """One SLA tier.  ``level`` orders tiers (0 = most urgent, served
    first).  ``deadline`` is the tier's SLA target (seconds from submit;
    informational — stamped onto each job).  ``escalate_after`` is the
    wait after which a queued job is promoted one level (defaults to the
    deadline; ``math.inf`` = never escalate)."""

    name: str
    level: int
    deadline: float
    escalate_after: Optional[float] = None

    @property
    def escalation_wait(self) -> float:
        return (self.deadline if self.escalate_after is None
                else self.escalate_after)


DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("premium", 0, deadline=1.0, escalate_after=math.inf),
    TierSpec("standard", 1, deadline=4.0),
    TierSpec("batch", 2, deadline=math.inf, escalate_after=30.0),
)


class TokenBucket:
    """Classic token bucket: ``burst`` capacity, ``rate`` tokens/second.
    ``try_take`` consumes one token if available; refill is computed
    lazily from the caller-supplied ``now`` (no wall-clock reads here, so
    quota decisions are replayable)."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be > 0, "
                             f"got rate={rate}, burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now if self._last is None else max(self._last, now)

    def try_take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def time_until_token(self, now: float) -> float:
        """Seconds until one token is available (0 if already)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

_job_counter = [0]
_job_counter_lock = threading.Lock()


def _next_job_id() -> int:
    with _job_counter_lock:
        _job_counter[0] += 1
        return _job_counter[0]


@dataclass
class Job:
    """One accepted generation request travelling through the front door.

    ``quality_tier`` maps the SLA tier onto the scheduler's existing
    quality-aware priority fast path (``fast_path="priority"`` in
    ``repro_torch.core.scheduler``): ``None`` derives it from the tier (level 0
    = premium ⇒ True), an explicit bool wins.  ``deadline`` is absolute
    (``submitted_at + tier.deadline``).  The dispatcher fills
    ``admitted_at``/``finished_at``; the gateway attaches the completion
    handle.
    """

    tenant: str
    tier: str
    prompt: str
    seed: int = 0
    quality_tier: Optional[bool] = None
    submitted_at: float = 0.0
    deadline: float = math.inf
    job_id: int = field(default_factory=_next_job_id)
    # effective tier after deadline escalations (starts == tier)
    effective_tier: str = ""
    escalations: int = 0
    admitted_at: float = -1.0
    finished_at: float = -1.0
    handle: object = None

    def __post_init__(self):
        if not self.effective_tier:
            self.effective_tier = self.tier


# ---------------------------------------------------------------------------
# the queue
# ---------------------------------------------------------------------------


@dataclass
class QueueStats:
    accepted: int = 0
    dispatched: int = 0
    rejected_quota: int = 0
    rejected_backpressure: int = 0
    escalations: int = 0
    # per-tenant accepted/rejected tallies for the fairness reports
    accepted_by_tenant: Dict[str, int] = field(default_factory=dict)
    rejected_by_tenant: Dict[str, int] = field(default_factory=dict)


class FrontDoorQueue:
    """Priority/SLA-tier queue with per-tenant quotas and fair dequeue
    (see the module docstring for the policy).  Thread-safe; all methods
    take an explicit ``now``."""

    def __init__(self, *, tiers: Sequence[TierSpec] = DEFAULT_TIERS,
                 max_depth: int = 256,
                 quotas: Optional[Dict[str, TokenBucket]] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 fair: bool = True):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        levels = sorted(t.level for t in tiers)
        if levels != list(range(len(tiers))):
            raise ValueError(f"tier levels must be 0..{len(tiers) - 1}, "
                             f"got {levels}")
        self.tiers: Dict[str, TierSpec] = {t.name: t for t in tiers}
        self.by_level: List[TierSpec] = sorted(tiers, key=lambda t: t.level)
        self.max_depth = max_depth
        self.quotas = dict(quotas or {})
        self.tenant_weights = dict(tenant_weights or {})
        self.fair = fair
        self.stats = QueueStats()
        # (level, tenant) -> FIFO of jobs; per-tenant fair-share state
        self._queues: Dict[Tuple[int, str], Deque[Job]] = {}
        self._vtime: Dict[str, float] = {}
        self._vclock = 0.0
        self._depth = 0
        self._lock = threading.Condition()

    # -- admission ----------------------------------------------------------

    def submit(self, job: Job, now: float) -> Job:
        """Admission-control a job into the queue (or raise).

        Order of checks: unknown tier (``ValueError``) → global depth
        bound (:class:`BackpressureError`) → tenant token bucket
        (:class:`QuotaExceededError`).  On accept the job is stamped with
        ``submitted_at = now`` and its absolute SLA ``deadline``.
        """
        if job.tier not in self.tiers:
            raise ValueError(f"unknown tier {job.tier!r} "
                             f"(have {sorted(self.tiers)})")
        spec = self.tiers[job.tier]
        with self._lock:
            if self._depth >= self.max_depth:
                self.stats.rejected_backpressure += 1
                self._bump(self.stats.rejected_by_tenant, job.tenant)
                raise BackpressureError(
                    f"queue full ({self._depth}/{self.max_depth}); "
                    f"rejecting {job.tenant}/{job.tier}",
                    tenant=job.tenant, tier=job.tier, depth=self._depth,
                    bound=self.max_depth)
            bucket = self.quotas.get(job.tenant)
            if bucket is not None and not bucket.try_take(now):
                self.stats.rejected_quota += 1
                self._bump(self.stats.rejected_by_tenant, job.tenant)
                raise QuotaExceededError(
                    f"tenant {job.tenant!r} over quota "
                    f"({bucket.rate:g}/s, burst {bucket.burst:g})",
                    tenant=job.tenant, tier=job.tier, depth=self._depth,
                    bound=self.max_depth,
                    retry_after=bucket.time_until_token(now))
            job.submitted_at = now
            job.deadline = now + spec.deadline
            job.effective_tier = job.tier
            self._enqueue(spec.level, job)
            self.stats.accepted += 1
            self._bump(self.stats.accepted_by_tenant, job.tenant)
            self._lock.notify_all()
            return job

    # -- dequeue ------------------------------------------------------------

    def next_batch(self, n: int, now: float) -> List[Job]:
        """Dequeue up to ``n`` jobs in policy order: escalate overdue
        jobs, then repeatedly take the head of the highest-priority
        non-empty tier, picking the tenant with the lowest fair-share
        virtual time (FIFO across tenants when ``fair=False``).  One
        batch may mix tiers — lower tiers fill the slots the higher
        tiers do not need, so spare capacity is never wasted."""
        out: List[Job] = []
        with self._lock:
            self._escalate(now)
            while len(out) < n:
                job = self._pop_one()
                if job is None:
                    break
                out.append(job)
            self.stats.dispatched += len(out)
        return out

    def wait_for_jobs(self, timeout: float) -> bool:
        """Block until the queue is non-empty (or ``timeout`` elapses);
        the dispatcher worker parks here between groups."""
        with self._lock:
            if self._depth:
                return True
            return self._lock.wait(timeout)

    def kick(self) -> None:
        """Wake any :meth:`wait_for_jobs` waiter without enqueuing —
        used by the dispatcher to apply control ops / shutdown promptly."""
        with self._lock:
            self._lock.notify_all()

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return self._depth

    def depth_by_tenant(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for (_, tenant), q in self._queues.items():
                out[tenant] = out.get(tenant, 0) + len(q)
            return out

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _bump(d: Dict[str, int], key: str) -> None:
        d[key] = d.get(key, 0) + 1

    def _enqueue(self, level: int, job: Job) -> None:
        self._queues.setdefault((level, job.tenant),
                                deque()).append(job)
        self._depth += 1

    def _escalate(self, now: float) -> None:
        """Promote overdue jobs one level (tail of the higher tier).
        Within one per-tenant FIFO the head is oldest, so popping
        overdue heads catches every overdue job."""
        for spec in self.by_level[1:]:          # level 0 cannot escalate
            wait = spec.escalation_wait
            if not math.isfinite(wait):
                continue
            for (level, tenant), q in list(self._queues.items()):
                if level != spec.level:
                    continue
                while q and now - q[0].submitted_at >= wait:
                    job = q.popleft()
                    job.effective_tier = self.by_level[level - 1].name
                    job.escalations += 1
                    self.stats.escalations += 1
                    self._queues.setdefault((level - 1, tenant),
                                            deque()).append(job)

    def _pop_one(self) -> Optional[Job]:
        for spec in self.by_level:
            tenants = [t for (lvl, t), q in self._queues.items()
                       if lvl == spec.level and q]
            if not tenants:
                continue
            if self.fair:
                tenant = min(tenants,
                             key=lambda t: (self._vtime.get(t, 0.0), t))
            else:       # FIFO across tenants: oldest head wins
                tenant = min(
                    tenants,
                    key=lambda t: (self._queues[(spec.level, t)][0]
                                   .submitted_at,
                                   self._queues[(spec.level, t)][0].job_id))
            q = self._queues[(spec.level, tenant)]
            job = q.popleft()
            self._depth -= 1
            # start-time fair queueing: charge 1/weight virtual seconds
            w = max(self.tenant_weights.get(tenant, 1.0), 1e-9)
            v = max(self._vtime.get(tenant, 0.0), self._vclock)
            self._vtime[tenant] = v + 1.0 / w
            self._vclock = v
            return job
        return None
