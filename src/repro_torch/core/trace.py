"""Request-trace generator + arrival processes for the serving experiments.

Real text-to-image traffic is heavy-tailed with topic drift (NIRVANA's
production observation, which the paper's LCU experiment leans on: "5 cache
updates" under a shifting query distribution).  We model:

  * a Zipf popularity law over scene specs,
  * topic drift: the Zipf ranking rotates every ``drift_every`` requests,
  * optional quality-tier users (paper's artistic/professional requests),
  * near-duplicate prompts (verbatim repeats) at rate ``repeat_rate`` to
    exercise the historical-query cache.

WHAT arrives is only half a workload — WHEN it arrives is the other half.
The paper's §V deployment sits behind an asynchronous task queue, so
latency under load depends on the arrival process.  :class:`TimedRequest`
stamps each trace request with an arrival time on the serving clock, and
three generators build the processes the experiments need:

  * :func:`poisson_arrivals` — memoryless open-loop traffic at a given
    offered load (requests/second), the queueing-theory baseline;
  * :func:`trace_arrivals` — trace-driven replay of explicit timestamps
    (recorded production traces, adversarial schedules, test fixtures);
  * :func:`bursty_arrivals` — synchronized bursts separated by idle gaps,
    the worst case for fixed-drain batching (stragglers that miss a batch
    boundary wait out a whole burst period).

All three preserve request order and are deterministic in their seed.
Multi-tenant traffic is built by tagging each process with a
``tenant``/``tier`` and interleaving them with :func:`merge_arrivals`
(stable, deterministic tie-break on equal timestamps) — one trace
generator becomes one client among many at the front door
(:mod:`repro_torch.frontdoor`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.data.synthetic import (COLORS, SceneSpec, all_specs, caption_of,
                                  random_spec)


@dataclass
class TraceRequest:
    """One untimed trace entry: the prompt, its ground-truth scene spec,
    whether the issuing user is quality-tier (the paper's
    artistic/professional requests, eligible for priority scheduling),
    and whether this is a verbatim repeat of the previous request (the
    historical-query-cache workload knob)."""

    prompt: str
    spec: SceneSpec
    quality_tier: bool = False
    is_repeat: bool = False


@dataclass
class RequestTrace:
    """Deterministic Zipf-with-drift request generator (WHAT arrives).

    ``n_specs`` scenes are drawn once from the synthetic pool;
    :meth:`generate` then samples prompts Zipf(``zipf_a``)-popular over
    them, rotating which scenes are popular every ``drift_every``
    requests (topic drift), repeating the previous prompt verbatim at
    ``repeat_rate``, and tagging requests quality-tier at
    ``quality_rate``.  Identical seeds yield identical traces — every
    parity/property test in the repo leans on this."""

    n_specs: int = 400
    zipf_a: float = 1.2
    drift_every: int = 250
    repeat_rate: float = 0.08
    quality_rate: float = 0.05
    seed: int = 0
    _specs: List[SceneSpec] = field(default_factory=list)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        seen = set()
        while len(self._specs) < self.n_specs:
            s = random_spec(rng)
            if s.key() not in seen:
                seen.add(s.key())
                self._specs.append(s)

    def generate(self, n: int) -> Iterator[TraceRequest]:
        """Yield ``n`` :class:`TraceRequest`\\ s (deterministic in the
        trace seed; see the class docstring for the sampling law).  Pair
        with :func:`poisson_arrivals` / :func:`trace_arrivals` /
        :func:`bursty_arrivals` to add WHEN each request lands."""
        rng = np.random.default_rng(self.seed + 1)
        order = rng.permutation(self.n_specs)
        # Zipf over ranks, truncated to the spec pool
        ranks = np.arange(1, self.n_specs + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        probs /= probs.sum()
        last_prompt: Optional[TraceRequest] = None
        for i in range(n):
            if i > 0 and i % self.drift_every == 0:
                # topic drift: rotate which specs are popular
                order = np.roll(order, self.n_specs // 7)
            if last_prompt is not None and rng.random() < self.repeat_rate:
                yield TraceRequest(last_prompt.prompt, last_prompt.spec,
                                   quality_tier=rng.random() < self.quality_rate,
                                   is_repeat=True)
                continue
            rank = rng.choice(self.n_specs, p=probs)
            spec = self._specs[order[rank]]
            req = TraceRequest(caption_of(spec), spec,
                               quality_tier=rng.random() < self.quality_rate)
            last_prompt = req
            yield req

    @property
    def specs(self) -> List[SceneSpec]:
        return list(self._specs)


def band_mutation_trace(n: int, *, band_fraction: float = 0.5,
                        seed: int = 0) -> List[TraceRequest]:
    """Novel-spec / attribute-mutation workload for the latent-depth cache.

    The Zipf trace's img2img-band matches overwhelmingly land on the
    pre-seeded reference corpus, whose entries carry no archived latents —
    so it never exercises depth resumes.  This trace does, by
    construction: each request is either a *base* (a scene spec never
    requested before, drawn from a seeded permutation of the full spec
    pool — routes txt2img against a small corpus and is archived with
    latents) or, with probability ``band_fraction``, a single-attribute
    *mutation* (color swap) of a previously requested base.  Mutations
    score in or near the paper's [lo, hi] reference band against their
    base's archived generation, which is exactly the workload where
    resuming from a noised intermediate saves denoising steps.

    Pair with a small seed corpus (``corpus_n`` ≲ 50) so served archives,
    not warm corpus entries, win retrieval.  Deterministic in ``seed``.
    """
    if not 0.0 <= band_fraction <= 1.0:
        raise ValueError(f"band_fraction must be in [0, 1], "
                         f"got {band_fraction}")
    rng = np.random.default_rng(seed)
    specs = all_specs()
    perm = rng.permutation(len(specs))
    bases: List[SceneSpec] = []
    out: List[TraceRequest] = []
    nxt = 0
    for _ in range(n):
        if bases and rng.random() < band_fraction:
            b = bases[int(rng.integers(len(bases)))]
            colors = [c for c in COLORS if c != b.color]
            mut = SceneSpec(b.shape, colors[int(rng.integers(len(colors)))],
                            b.background, b.size, b.position)
            out.append(TraceRequest(caption_of(mut), mut))
        else:
            b = specs[perm[nxt % len(specs)]]
            nxt += 1
            bases.append(b)
            out.append(TraceRequest(caption_of(b), b))
    return out


def mixed_hit_trace(n: int, *, band_fraction: float = 0.35,
                    repeat_fraction: float = 0.25,
                    seed: int = 0) -> List[TraceRequest]:
    """Hit-rate-mix workload: every route class in one stream.

    Extends :func:`band_mutation_trace` with VERBATIM repeats of earlier
    requests, so a single trace exercises txt2img misses (novel bases),
    img2img band hits and latent-depth resumes (mutations), AND
    HIT_RETURN / history fast paths (repeats) — the full step-count
    spread the step-level serving engine's ragged admission has to
    interleave (its property suite draws hit mixes from here).  Each
    request is a repeat with probability ``repeat_fraction``, else a
    mutation with probability ``band_fraction``, else a fresh base.
    Deterministic in ``seed``; repeats are tagged ``is_repeat``.
    """
    if not 0.0 <= repeat_fraction <= 1.0:
        raise ValueError(f"repeat_fraction must be in [0, 1], "
                         f"got {repeat_fraction}")
    if not 0.0 <= band_fraction <= 1.0:
        raise ValueError(f"band_fraction must be in [0, 1], "
                         f"got {band_fraction}")
    rng = np.random.default_rng(seed + 7)
    body = band_mutation_trace(n, band_fraction=band_fraction, seed=seed)
    out: List[TraceRequest] = []
    for req in body:
        if out and rng.random() < repeat_fraction:
            prev = out[int(rng.integers(len(out)))]
            out.append(TraceRequest(prev.prompt, prev.spec,
                                    quality_tier=prev.quality_tier,
                                    is_repeat=True))
        else:
            out.append(req)
    return out


# ---------------------------------------------------------------------------
# arrival processes (timestamped traffic for the continuous-batching engine)
# ---------------------------------------------------------------------------


@dataclass
class TimedRequest:
    """A trace request stamped with its arrival time on the serving clock.

    ``arrival_time`` is in seconds on the engine's virtual clock (which
    advances by measured service wall time, so simulated gaps and real
    compute compose).  ``seed`` defaults to the request's position in the
    stream so replays match the seeded drivers elsewhere in the repo.
    """

    arrival_time: float
    prompt: str
    seed: int = 0
    quality_tier: bool = False
    spec: Optional[SceneSpec] = None
    is_repeat: bool = False
    # multi-tenant serving tags (None = untagged legacy traffic): which
    # tenant issued the request and at which SLA tier.  The front-door
    # gateway and the tagged-percentile stats key on these; every
    # existing untagged call site is unchanged.
    tenant: Optional[str] = None
    tier: Optional[str] = None


def _as_timed(reqs: Iterable, times: Sequence[float],
              seed_base: int = 0, tenant: Optional[str] = None,
              tier: Optional[str] = None) -> List[TimedRequest]:
    out: List[TimedRequest] = []
    for i, (r, t) in enumerate(zip(reqs, times)):
        if isinstance(r, TraceRequest):
            out.append(TimedRequest(float(t), r.prompt, seed=seed_base + i,
                                    quality_tier=r.quality_tier,
                                    spec=r.spec, is_repeat=r.is_repeat,
                                    tenant=tenant, tier=tier))
        else:
            out.append(TimedRequest(float(t), str(r), seed=seed_base + i,
                                    tenant=tenant, tier=tier))
    return out


def poisson_arrivals(reqs: Iterable, rate: float, *, seed: int = 0,
                     start: float = 0.0, seed_base: int = 0,
                     tenant: Optional[str] = None,
                     tier: Optional[str] = None) -> List[TimedRequest]:
    """Open-loop Poisson arrivals at ``rate`` requests/second.

    Inter-arrival gaps are i.i.d. exponential with mean ``1/rate``;
    request order is preserved.  ``reqs`` may be :class:`TraceRequest`
    objects or bare prompt strings.  Generation seeds are assigned as
    ``seed_base + position`` — offset ``seed_base`` when timing a later
    slice of a longer trace so seeds stay distinct across slices.
    ``tenant``/``tier`` tag every request (one arrival process = one
    tenant's traffic; interleave tenants with :func:`merge_arrivals`).
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    reqs = list(reqs)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(reqs))
    times = start + np.cumsum(gaps)
    return _as_timed(reqs, times, seed_base, tenant, tier)


def trace_arrivals(reqs: Iterable, timestamps: Sequence[float],
                   *, seed_base: int = 0, tenant: Optional[str] = None,
                   tier: Optional[str] = None) -> List[TimedRequest]:
    """Trace-driven arrivals: replay explicit per-request timestamps.

    ``timestamps`` must be non-decreasing and as long as ``reqs`` — this is
    the injection point for recorded production traces and for tests that
    need adversarial schedules.
    """
    reqs = list(reqs)
    times = [float(t) for t in timestamps]
    if len(times) != len(reqs):
        raise ValueError(f"{len(reqs)} requests but {len(times)} timestamps")
    if any(b < a for a, b in zip(times, times[1:])):
        raise ValueError("timestamps must be non-decreasing")
    return _as_timed(reqs, times, seed_base, tenant, tier)


def merge_arrivals(*processes: Sequence[TimedRequest]) -> List[TimedRequest]:
    """Interleave per-tenant arrival processes into one timeline.

    The merge is by ``arrival_time`` with a DETERMINISTIC, STABLE
    tie-break: requests landing at the same instant keep the order of
    their processes in the argument list, and within one process their
    original order — so ``merge_arrivals(a, b)`` is reproducible and
    ``merge_arrivals(a) == list(a)``.  Tags travel with the requests
    (build each process with its own ``tenant``/``tier``).

    Seed discipline: each process assigns generation seeds as
    ``seed_base + position``, so give every process a distinct
    ``seed_base`` (e.g. ``i * len(reqs_i)``) to keep seeds unique in the
    merged stream.
    """
    tagged = [(r.arrival_time, pi, j, r)
              for pi, proc in enumerate(processes)
              for j, r in enumerate(proc)]
    tagged.sort(key=lambda x: (x[0], x[1], x[2]))
    return [r for _, _, _, r in tagged]


def bursty_arrivals(reqs: Iterable, *, burst_size: int, burst_gap: float,
                    within_burst_gap: float = 0.0,
                    start: float = 0.0,
                    seed_base: int = 0,
                    tenant: Optional[str] = None,
                    tier: Optional[str] = None) -> List[TimedRequest]:
    """Synchronized bursts: ``burst_size`` requests land together every
    ``burst_gap`` seconds (spaced ``within_burst_gap`` apart inside the
    burst).  This is the fixed-drain worst case: a request that misses a
    batch-closure boundary waits out the idle gap until the next burst
    refills the bucket, while a continuous engine serves it as soon as the
    in-flight group completes.
    """
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    if burst_gap < 0 or within_burst_gap < 0:
        raise ValueError("burst_gap and within_burst_gap must be >= 0")
    reqs = list(reqs)
    times = [start + (i // burst_size) * burst_gap
             + (i % burst_size) * within_burst_gap
             for i in range(len(reqs))]
    return _as_timed(reqs, times, seed_base, tenant, tier)
