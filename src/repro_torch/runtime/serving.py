"""Serving engine: CacheGenius front end over an eager diffusion backend —
the port of the JAX package's ``repro/runtime/serving.py``.

* :class:`DiffusionBackend` — txt2img / img2img over a DiT + VAE on the
  card, plus the latent-depth surface (``archive_latents_batch``,
  ``resume_batch``) and the slot engine of step-level serving.  PyTorch
  runs eagerly, so there is no AOT registry: a group is padded to a
  power-of-two batch (as in the JAX package, so that padding rules and
  per-request results match) and run directly.
* :class:`DiffusionSlotEngine` / :class:`EmulatedSlotEngine` — the
  step-level slot engines: a fixed-capacity buffer of in-flight chains
  advanced one denoising step per call.
* :class:`ServingEngine` — the request queue over the CacheGenius
  orchestrator: ``submit`` + ``drain`` serve everything queued in FIFO
  micro-batches of ``max_batch``; ``run`` serves a timestamped arrival
  process on a virtual clock, in continuous or fixed-drain mode, or with
  ``step_level=True`` at denoising-step granularity.

* :func:`tenant_tier_stats` — the front door's per-(tenant, tier)
  latency percentiles (``ServingEngine.tagged_stats``).

Not ported here: the LM response cache and the AOT ``precompile`` (eager
PyTorch has nothing to compile ahead).

Precision: the port holds the card to f32.  A ``DiffusionBackend`` built
on a CUDA device turns TF32 off for matmuls and cuDNN convolutions
(PyTorch's default runs the VAE's convolutions in TF32).  The flags are
process globals, set once at construction, before any worker thread
(the front door's dispatcher) runs the backend.

Noise: the JAX backend draws each request's initial noise from
``jax.random.split(PRNGKey(seed))``.  The port does not copy threefry; it
takes a ``noise_fn(seeds, shape, device) -> Tensor``.  The default,
:func:`seeded_noise`, draws each element from its own
``torch.Generator`` seeded with the request's seed, so batching never
changes a request's noise.  Tests pass the JAX draw instead.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.pipeline import TransientBackendError
from repro_torch.core.system import (CacheGenius, GenerationBackend, Plan,
                                     ServeResult)
from repro_torch.core.trace import TimedRequest
from repro_torch.models.diffusion.dit import DiT, make_eps_fn
from repro_torch.models.diffusion.sampler import (ddim_sample,
                                                  ddim_timesteps,
                                                  resume_noise_levels,
                                                  resume_sample, sdedit_start,
                                                  step_slots)
from repro_torch.models.diffusion.schedule import DiffusionSchedule
from repro_torch.models.diffusion.vae import VAE
from repro_torch.utils import next_pow2


def seeded_noise(seeds: Sequence[int], shape, device) -> torch.Tensor:
    """One N(0, I) draw of ``shape`` per seed, each from its own
    ``torch.Generator(device).manual_seed(seed)``."""
    out = torch.empty((len(seeds),) + tuple(shape), dtype=torch.float32,
                      device=device)
    for i, seed in enumerate(seeds):
        g = torch.Generator(device=device).manual_seed(int(seed))
        out[i] = torch.randn(tuple(shape), generator=g, device=device)
    return out


def _pad_rows(x: np.ndarray, bucket: int) -> np.ndarray:
    """``x`` padded to ``bucket`` rows by repeating its last row."""
    x = np.asarray(x, np.float32)
    pad = bucket - x.shape[0]
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]) if pad else x


class DiffusionBackend(GenerationBackend):
    """txt2img/img2img over a DiT+VAE, with the latent-depth cache
    surface.  ``embed_prompt`` maps a prompt to the conditioning vector
    (the proxy CLIP embedder in practice).

    ``archive_latents_batch`` draws its noise through the same per-seed
    ``noise_fn`` as ``img2img_batch``, so the depth-0 latent is the SDEdit
    initial state and ``resume_batch(k=0)`` replays img2img."""

    supports_latent_resume = True

    def __init__(self, dit: DiT, vae: VAE,
                 embed_prompt: Callable[[str], np.ndarray], *,
                 schedule: Optional[DiffusionSchedule] = None,
                 latent_scale: float = 1.0, img2img_strength: float = 0.6,
                 noise_fn: Optional[Callable] = None, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dit = dit.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.net_cfg = dit.cfg
        self.vae_cfg = vae.cfg
        self.embed_prompt = embed_prompt
        self.sched = (DiffusionSchedule.linear(1000, device=self.device)
                      if schedule is None else schedule.to(self.device))
        self.latent_scale = latent_scale
        self.strength = img2img_strength
        self.noise_fn = noise_fn or seeded_noise

    @property
    def image_res(self) -> int:
        return self.vae_cfg.downsample * self.net_cfg.img_res

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        cfg = self.net_cfg
        return (cfg.img_res, cfg.img_res, cfg.in_ch)

    def _pad_ctx_seeds(self, prompts: Sequence[str], seeds: Sequence[int],
                       bucket: int):
        """Conditioning rows and seeds padded to ``bucket`` (the last
        prompt repeated, seed 0), as in the JAX package."""
        ctx = np.stack([np.asarray(self.embed_prompt(p), np.float32)
                        for p in prompts])
        return (torch.from_numpy(_pad_rows(ctx, bucket)).to(self.device),
                list(seeds) + [0] * (bucket - len(prompts)))

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.image_res, self.image_res, 3), np.float32)

    def _encode(self, images: np.ndarray, seeds: Sequence[int]):
        """VAE-encode host images (B, H, W, 3) and draw each one's
        per-seed noise: ``(z0, noise)`` on the device."""
        mean, _ = self.vae.encode(torch.from_numpy(
            np.asarray(images, np.float32)).to(self.device))
        z0 = mean * self.latent_scale
        return z0, self.noise_fn(seeds, tuple(z0.shape[1:]), self.device)

    def _decode(self, z) -> torch.Tensor:
        return self.vae.decode(z / self.latent_scale)

    @torch.inference_mode()
    def txt2img_batch(self, prompts: Sequence[str], steps: int,
                      seeds: Sequence[int]) -> np.ndarray:
        """Batched text-to-image: the group padded to a power of two, one
        DDIM chain, one VAE decode."""
        n = len(prompts)
        if n == 0:
            return self._empty()
        ctx, seeds = self._pad_ctx_seeds(prompts, seeds, next_pow2(n))
        x_init = self.noise_fn(seeds, self.latent_shape, self.device)
        z = ddim_sample(make_eps_fn(self.dit), self.sched, x_init.shape, ctx,
                        steps=steps, x_init=x_init)
        return self._decode(z)[:n].cpu().numpy()

    @torch.inference_mode()
    def img2img_batch(self, prompts: Sequence[str], references: np.ndarray,
                      steps: int, seeds: Sequence[int]) -> np.ndarray:
        """Batched SDEdit img2img over stacked references (B, H, W, 3)."""
        n = len(prompts)
        if n == 0:
            return self._empty()
        bucket = next_pow2(n)
        ctx, seeds = self._pad_ctx_seeds(prompts, seeds, bucket)
        z_ref, noise = self._encode(_pad_rows(references, bucket), seeds)
        x_init, t_start = sdedit_start(self.sched, z_ref, noise,
                                       strength=self.strength)
        z = ddim_sample(make_eps_fn(self.dit), self.sched, z_ref.shape, ctx,
                        steps=steps, x_init=x_init, t_start=t_start)
        return self._decode(z)[:n].cpu().numpy()

    # -- latent-depth cache surface -------------------------------------------

    @torch.inference_mode()
    def resume_batch(self, prompts: Sequence[str], latents: np.ndarray,
                     steps_total: int, k: int,
                     seeds: Sequence[int]) -> np.ndarray:
        """Resume the ``steps_total``-step img2img chain from depth ``k``
        for a stacked batch of archived latents (no noise draw: they were
        noised at archive time, so ``seeds`` only shapes the padding)."""
        n = len(prompts)
        if n == 0:
            return self._empty()
        bucket = next_pow2(n)
        ctx, _ = self._pad_ctx_seeds(prompts, seeds, bucket)
        lats = torch.from_numpy(_pad_rows(latents, bucket)).to(self.device)
        z = resume_sample(make_eps_fn(self.dit), self.sched, lats, ctx,
                          steps=steps_total, k=int(k),
                          strength=self.strength)
        return self._decode(z)[:n].cpu().numpy()

    @torch.inference_mode()
    def archive_latents_batch(self, images: np.ndarray,
                              seeds: Sequence[int],
                              depths: Sequence[int],
                              steps_total: int) -> np.ndarray:
        """Noised img2img-chain intermediates of each image at every
        requested depth — ``(len(depths), B, img_res, img_res, in_ch)``;
        depth k is ``q_sample(z0, resume_noise_levels(...)[k], noise)``."""
        n = np.asarray(images).shape[0]
        if n == 0:
            return np.zeros((len(depths), 0) + self.latent_shape, np.float32)
        bucket = next_pow2(n)
        z0, noise = self._encode(_pad_rows(images, bucket),
                                 list(seeds) + [0] * (bucket - n))
        levels = resume_noise_levels(self.sched, steps=steps_total,
                                     strength=self.strength)
        out = torch.stack([
            self.sched.q_sample(
                z0, torch.full((bucket,), levels[int(k)], dtype=torch.long,
                               device=self.device), noise)
            for k in depths])
        return out[:, :n].cpu().numpy()

    # -- step-level slot engine ----------------------------------------------

    def make_slot_engine(self, capacity: int) -> "DiffusionSlotEngine":
        return DiffusionSlotEngine(self, capacity)

    def slot_init(self, plan, seed: int) -> Tuple[torch.Tensor, np.ndarray]:
        """A gen plan's initial slot latent (device, ``latent_shape``) and
        its descending DDIM timesteps, exactly as the group samplers would
        start it: txt2img from the seed's noise; img2img from the encoded
        reference noised by ``sdedit_start``; a ``resume@k`` plan from its
        archived latent, running the tail of the truncated chain."""
        t_img = int(self.strength * self.sched.T)
        if plan.latent is not None:
            steps_total = int(plan.steps) + int(plan.resume_k)
            ts = ddim_timesteps(self.sched.T, steps_total, t_start=t_img)
            x0 = torch.from_numpy(np.asarray(plan.latent, np.float32))
            return x0.to(self.device), ts[int(plan.resume_k):]
        if plan.ref is not None:
            z_ref, noise = self._encode(np.asarray(plan.ref)[None], [seed])
            x0, _ = sdedit_start(self.sched, z_ref, noise,
                                 strength=self.strength)
            return x0[0], ddim_timesteps(self.sched.T, int(plan.steps),
                                         t_start=t_img)
        x0 = self.noise_fn([seed], self.latent_shape, self.device)[0]
        return x0, ddim_timesteps(self.sched.T, int(plan.steps))


# ---------------------------------------------------------------------------
# step-level slot engines (ragged in-flight set, one denoising step / call)
# ---------------------------------------------------------------------------


class DiffusionSlotEngine:
    """Persistent step-wise sampler over a fixed-capacity slot buffer.

    Each occupied slot holds one in-flight request's latent, conditioning
    and DDIM timestep sub-sequence; every :meth:`step` advances ALL slots
    one denoising step through one DiT forward at the full capacity, with
    per-slot timesteps (:func:`~repro_torch.models.diffusion.sampler.
    step_slots`), so chains of mixed lengths (txt2img, truncated img2img,
    ``resume@k``) enter and retire at any step boundary.

    The latent, context, timestep and active buffers live on the
    backend's device and are updated in place; only a retired slot's
    decoded image comes back to the host (the JAX engine copies the whole
    buffer to host numpy every step).  Slot init reuses the group
    samplers' seed -> noise draws (:meth:`DiffusionBackend.slot_init`).
    ``progress[handle]`` records a slot's step index after each advance
    and ``step_calls`` counts steps."""

    @torch.inference_mode()
    def __init__(self, backend: DiffusionBackend, capacity: int):
        self.backend = backend
        self.capacity = int(capacity)
        dev = backend.device
        self._lat = torch.zeros((self.capacity,) + backend.latent_shape,
                                device=dev)
        self._ctx = torch.zeros((self.capacity, backend.net_cfg.ctx_dim),
                                device=dev)
        self._t = torch.zeros((self.capacity,), dtype=torch.int32,
                              device=dev)
        self._t_prev = torch.full((self.capacity,), -1, dtype=torch.int32,
                                  device=dev)
        self._on = torch.zeros((self.capacity,), dtype=torch.bool,
                               device=dev)
        self._active = np.zeros((self.capacity,), bool)   # host copy
        self._ts: List[Optional[np.ndarray]] = [None] * self.capacity
        self._pos = [0] * self.capacity
        self._state: List[Optional[object]] = [None] * self.capacity
        self._handle = [-1] * self.capacity
        self.progress: Dict[int, List[int]] = {}
        self.step_calls = 0

    def free_count(self) -> int:
        return int(self.capacity - self._active.sum())

    def active_count(self) -> int:
        return int(self._active.sum())

    @torch.inference_mode()
    def admit(self, state, handle: int) -> None:
        """Seat one planned ``gen`` request in a free slot."""
        b = self.backend
        slot = int(np.argmin(self._active))
        if self._active[slot]:
            raise RuntimeError("slot engine is full")
        x0, ts = b.slot_init(state.plan, state.seed)
        self._lat[slot] = x0
        self._ctx[slot] = torch.from_numpy(
            np.asarray(b.embed_prompt(state.prompt), np.float32))
        self._ts[slot] = np.asarray(ts)
        self._pos[slot] = 0
        self._state[slot] = state
        self._handle[slot] = int(handle)
        self._active[slot] = True
        self.progress[int(handle)] = [0]

    @torch.inference_mode()
    def step(self) -> List[Tuple[int, object]]:
        """Advance every active slot one DDIM step; decode and free the
        slots whose chain just ended.  Returns the retired
        ``(handle, state)`` pairs (``state.image`` set)."""
        b = self.backend
        t = np.zeros((self.capacity,), np.int32)
        tp = np.full((self.capacity,), -1, np.int32)
        for i in np.flatnonzero(self._active):
            ts, p = self._ts[i], self._pos[i]
            t[i] = ts[p]
            tp[i] = ts[p + 1] if p + 1 < len(ts) else -1
        self._t.copy_(torch.from_numpy(t))
        self._t_prev.copy_(torch.from_numpy(tp))
        self._on.copy_(torch.from_numpy(self._active))
        self._lat = step_slots(make_eps_fn(b.dit), b.sched, self._lat,
                               self._ctx, self._t, self._t_prev, self._on)
        self.step_calls += 1
        retired: List[Tuple[int, object]] = []
        for i in np.flatnonzero(self._active):
            self._pos[i] += 1
            self.progress[self._handle[i]].append(self._pos[i])
            if self._pos[i] >= len(self._ts[i]):
                st = self._state[i]
                st.image = b._decode(self._lat[i:i + 1])[0].cpu().numpy()
                retired.append((self._handle[i], st))
                self._active[i] = False
                self._ts[i] = None
                self._state[i] = None
                self._handle[i] = -1
        return retired


class EmulatedSlotEngine:
    """Slot-engine surface for generic :class:`GenerationBackend`\\ s (no
    resident latent state).  Each admitted request's image is computed at
    admission as a batch of ONE — the call sequential ``serve`` makes — and
    the slot then counts down its plan's step budget, so admission and
    retirement interleave (and the clock, archive and maintenance order
    run) as on the real slot engine."""

    def __init__(self, system: CacheGenius, capacity: int):
        self.system = system
        self.capacity = int(capacity)
        self._remaining: List[int] = [0] * self.capacity
        self._state: List[Optional[object]] = [None] * self.capacity
        self._handle = [-1] * self.capacity
        self._active = np.zeros((self.capacity,), bool)
        self.progress: Dict[int, List[int]] = {}
        self.step_calls = 0

    def free_count(self) -> int:
        return int(self.capacity - self._active.sum())

    def active_count(self) -> int:
        return int(self._active.sum())

    def admit(self, state, handle: int) -> None:
        backend = self.system.backend
        plan = state.plan
        slot = int(np.argmin(self._active))
        if self._active[slot]:
            raise RuntimeError("slot engine is full")
        if plan.latent is not None:
            img = backend.resume_batch(
                [state.prompt], np.asarray(plan.latent)[None],
                int(plan.steps) + int(plan.resume_k), int(plan.resume_k),
                [state.seed])[0]
        elif plan.ref is not None:
            img = backend.img2img_batch(
                [state.prompt], np.asarray(plan.ref)[None],
                int(plan.steps), [state.seed])[0]
        else:
            img = backend.txt2img_batch(
                [state.prompt], int(plan.steps), [state.seed])[0]
        state.image = np.asarray(img)
        self._remaining[slot] = max(int(plan.steps), 1)
        self._state[slot] = state
        self._handle[slot] = int(handle)
        self._active[slot] = True
        self.progress[int(handle)] = [0]

    def step(self) -> List[Tuple[int, object]]:
        self.step_calls += 1
        retired: List[Tuple[int, object]] = []
        for i in range(self.capacity):
            if not self._active[i]:
                continue
            self._remaining[i] -= 1
            h = self._handle[i]
            self.progress[h].append(self.progress[h][-1] + 1)
            if self._remaining[i] <= 0:
                retired.append((h, self._state[i]))
                self._active[i] = False
                self._state[i] = None
                self._handle[i] = -1
        return retired


# ---------------------------------------------------------------------------
# batched request engine
# ---------------------------------------------------------------------------


@dataclass
class Request:
    prompt: str
    seed: int = 0
    quality_tier: bool = False
    submitted_at: float = 0.0   # perf_counter (drain) / virtual clock (run)
    # tenant tags of a tagged arrival process (None = untagged)
    tenant: Optional[str] = None
    tier: Optional[str] = None


@dataclass
class Completed:
    request: Request
    result: ServeResult
    queue_delay: float          # seconds actually waited before admission
    finished_at: float = 0.0    # engine-clock instant the result came back


class ServingEngine:
    """Asynchronous-queue semantics (paper §V "asynchronous task queue")
    over ``CacheGenius.serve_batch``.

    ``run`` is the continuous-batching event loop over a timestamped
    arrival process; ``submit`` + ``drain`` is the closed-loop surface
    (everything queued up front, FIFO micro-batches of ``max_batch``).
    On traces where distinct in-batch prompts do not interact through
    freshly archived images, every mode gives the sequential ``serve``
    loop's routes, nodes, steps and cache state; images match it exactly
    on a deterministic backend, and on the card within the rounding of
    batch-size-dependent GEMM algorithms."""

    def __init__(self, system: CacheGenius, *, max_batch: int = 8):
        self.system = system
        self.max_batch = max_batch
        self.queue: List[Request] = []
        self.completed: List[Completed] = []
        # step-level telemetry of the most recent step_level=True run:
        # active slots sampled before every step, and the engine itself
        self.slot_occupancy: List[int] = []
        self.last_slot_engine: Optional[object] = None

    # -- closed-loop surface ----------------------------------------------------

    def submit(self, prompt: str, *, seed: int = 0,
               quality_tier: bool = False) -> None:
        self.queue.append(Request(prompt, seed, quality_tier,
                                  submitted_at=time.perf_counter()))

    def serve_group(self, batch: Sequence[Request]) -> List[Completed]:
        """Serve ONE micro-batch now through one staged-pipeline pass;
        ``queue_delay`` is submission -> pipeline admission."""
        if not batch:
            return []
        results = self.system.serve_batch(
            [r.prompt for r in batch],
            seeds=[r.seed for r in batch],
            quality_tiers=[r.quality_tier for r in batch],
            submitted_ats=[r.submitted_at for r in batch])
        done_at = time.perf_counter()
        out = [Completed(req, res, queue_delay=res.queue_delay,
                         finished_at=done_at)
               for req, res in zip(batch, results)]
        self.completed.extend(out)
        return out

    def drain(self) -> List[Completed]:
        """Serve the whole queue in FIFO micro-batches of ``max_batch``."""
        out = []
        while self.queue:
            batch, self.queue = (self.queue[: self.max_batch],
                                 self.queue[self.max_batch:])
            out.extend(self.serve_group(batch))
        return out

    # -- continuous batching ----------------------------------------------------

    def run(self, arrivals: Iterable[TimedRequest], *,
            mode: str = "continuous", start: float = 0.0,
            step_level: bool = False, slot_capacity: Optional[int] = None,
            on_step: Optional[Callable[[int], None]] = None,
            ) -> List[Completed]:
        """Serve a timestamped arrival process; returns arrival order.

        The virtual clock starts at ``start`` and advances two ways:
        idling to the next arrival when nothing is queued, and by the
        MEASURED wall time of each pipeline pass while serving — so how
        requests group depends on the hardware.  To split one trace over
        several calls, pass the previous call's last ``finished_at`` as
        ``start``.

        ``mode="continuous"`` admits everything that has arrived (up to
        ``max_batch``) into the next group the moment the previous group
        completes; ``mode="drain"`` closes a group only once
        ``max_batch`` requests have arrived (or the trace ends).  Each
        ``Completed`` carries ``queue_delay`` = admission instant − arrival
        instant on the virtual clock (also stamped on the result) and
        ``finished_at`` = its completion instant.

        ``step_level=True`` (continuous mode only) admits at denoising-step
        granularity through a slot engine of ``slot_capacity`` slots
        (default ``max_batch``), retiring chains the step they end and
        finalizing them in submission order.  ``on_step(n)`` is called
        before each step (step level) or each group (group modes)."""
        if mode not in ("continuous", "drain"):
            raise ValueError(f"unknown mode {mode!r}")
        if step_level and mode != "continuous":
            raise ValueError("step_level=True requires mode='continuous'")
        if not step_level and slot_capacity is not None:
            raise ValueError(
                "slot_capacity only applies with step_level=True")
        if self.queue:
            raise RuntimeError(
                "ServingEngine.run would strand the submit() queue "
                f"({len(self.queue)} pending requests) — drain() it first")
        if step_level:
            return self._run_step_level(
                arrivals, start=start,
                slot_capacity=slot_capacity or self.max_batch,
                on_step=on_step)
        pending = deque(sorted(arrivals, key=lambda a: a.arrival_time))
        ready: List[TimedRequest] = []
        out: List[Completed] = []
        now = float(start)
        group_no = 0

        def admit_arrived() -> None:
            while pending and pending[0].arrival_time <= now + 1e-12:
                ready.append(pending.popleft())

        while pending or ready:
            admit_arrived()
            if mode == "drain":
                while len(ready) < self.max_batch and pending:
                    now = max(now, pending[0].arrival_time)
                    admit_arrived()
            if not ready:
                now = max(now, pending[0].arrival_time)
                continue
            batch, ready = ready[: self.max_batch], ready[self.max_batch:]
            if on_step is not None:
                on_step(group_no)
            group_no += 1
            admitted = now
            t0 = time.perf_counter()
            results = self.system.serve_batch(
                [r.prompt for r in batch],
                seeds=[r.seed for r in batch],
                quality_tiers=[r.quality_tier for r in batch])
            now = admitted + (time.perf_counter() - t0)
            for r, res in zip(batch, results):
                out.append(self._completed(r, res, admitted, now))
        self.completed.extend(out)
        return out

    @staticmethod
    def _completed(r: TimedRequest, res: ServeResult, admitted: float,
                   now: float) -> Completed:
        res.queue_delay = admitted - r.arrival_time
        req = Request(r.prompt, r.seed, r.quality_tier,
                      submitted_at=r.arrival_time, tenant=r.tenant,
                      tier=r.tier)
        return Completed(req, res, queue_delay=res.queue_delay,
                         finished_at=now)

    def _run_step_level(self, arrivals: Iterable[TimedRequest], *,
                        start: float, slot_capacity: int,
                        on_step: Optional[Callable[[int], None]],
                        ) -> List[Completed]:
        """Step-level continuous batching over a persistent slot engine.

        * ADMISSION — whenever slots are free and requests have arrived,
          one Embed..Plan pass (``ServePipeline.run_admission``) plans the
          group against the current cache; ``gen`` plans take slots, the
          rest complete at once.  Earlier unfinalized gen requests seed
          the Plan stage's coalescing set, so a near-duplicate arriving
          mid-flight aliases onto the in-flight slot.
        * RETIREMENT — a slot retires the step its chain ends, but
          Archive/Finish run in SUBMISSION order
          (``ServePipeline.finalize`` per request), so blob ids, history,
          eviction sweeps and stats follow the sequential loop.
        * TIMING — the virtual clock advances by the measured wall time
          of every admission pass, step and finalize pass; per-request
          ``stage_walls`` come from the slot's own timestamps.
        * FAULTS — a node that dies mid-flight (``on_step`` ->
          ``fail_node``) loses no accepted job: its slots finish and their
          archive reroutes to a surviving node at finalize."""
        system = self.system
        make = getattr(system.backend, "make_slot_engine", None)
        engine = (make(slot_capacity) if make is not None
                  else EmulatedSlotEngine(system, slot_capacity))
        self.last_slot_engine = engine
        self.slot_occupancy = []
        pending = deque(sorted(arrivals, key=lambda a: a.arrival_time))
        ready: List[TimedRequest] = []
        out: List[Completed] = []
        now = float(start)
        states: Dict[int, object] = {}
        arr_of: Dict[int, TimedRequest] = {}
        admit_t: Dict[int, float] = {}
        img_ready: Dict[int, bool] = {}
        alias_target: Dict[int, int] = {}
        inflight_gen: List[int] = []   # unfinalized gen handles, ascending
        next_handle = 0
        next_fin = 0
        step_no = 0

        def admit_arrived() -> None:
            while pending and pending[0].arrival_time <= now + 1e-12:
                ready.append(pending.popleft())

        def do_admission() -> None:
            nonlocal now, next_handle
            free = engine.free_count()
            batch, rest = ready[:free], ready[free:]
            ready[:] = rest
            base = next_handle
            admitted = now
            inflight = [(states[h].qvec, h) for h in inflight_gen]
            t0 = time.perf_counter()
            planned = system.pipeline.run_admission(
                system, [r.prompt for r in batch],
                seeds=[r.seed for r in batch],
                quality_tiers=[r.quality_tier for r in batch],
                inflight=inflight or None)
            for s, r in zip(planned, batch):
                h = base + s.index
                states[h], arr_of[h], admit_t[h] = s, r, admitted
                if s.plan.kind == "gen":
                    self._admit_with_retry(engine, s, h)
                    inflight_gen.append(h)
                    img_ready[h] = False
                elif s.plan.kind == "alias":
                    t = s.plan.target
                    alias_target[h] = base + t if t >= 0 else -(t + 1)
            next_handle += len(batch)
            now = admitted + (time.perf_counter() - t0)

        def finalize_due() -> None:
            nonlocal now, next_fin
            while next_fin < next_handle:
                st = states[next_fin]
                if st.plan.kind == "gen" and not img_ready[next_fin]:
                    break      # submission-order gate: wait for the slot
                if st.plan.kind == "alias":
                    # the target is an earlier gen request, already
                    # finalized by the gate: the history fast path
                    st.plan = Plan(kind="history",
                                   image=states[alias_target[next_fin]].image)
                elif st.plan.kind == "gen":
                    node = st.plan.node
                    if (0 <= node < len(system.dbs)
                            and not system.scheduler.nodes[node].alive):
                        alive = [i for i in range(len(system.dbs))
                                 if system.scheduler.nodes[i].alive]
                        if alive:   # reroute archive + accounting off the
                            st.plan.node = alive[0]   # dead node's VDB
                t0 = time.perf_counter()
                system.pipeline.finalize(system, st)
                now += time.perf_counter() - t0
                out.append(self._completed(arr_of[next_fin], st.result,
                                           admit_t[next_fin], now))
                if inflight_gen and inflight_gen[0] == next_fin:
                    inflight_gen.pop(0)
                next_fin += 1

        while pending or ready or next_fin < next_handle:
            admit_arrived()
            if ready and engine.free_count() > 0:
                do_admission()
                finalize_due()     # cached/history/alias complete at once
            if engine.active_count() > 0:
                if on_step is not None:
                    on_step(step_no)
                self.slot_occupancy.append(engine.active_count())
                t0 = time.perf_counter()
                retired = engine.step()
                now += time.perf_counter() - t0
                step_no += 1
                for h, st in retired:
                    st.stage_ts["Generate"] = time.perf_counter()
                    img_ready[h] = True
                finalize_due()
            elif not ready:
                finalize_due()
                if pending:
                    now = max(now, pending[0].arrival_time)
                elif next_fin >= next_handle:
                    break
        self.completed.extend(out)
        return out

    def _admit_with_retry(self, engine, state, handle: int) -> None:
        """Seat one gen plan in a slot, retrying transient backend faults
        as the Generate stage does (health bookkeeping included); the last
        failed attempt re-raises, so no accepted job is dropped."""
        system = self.system
        retries = getattr(system, "transient_retries", 0)
        sched = (system.scheduler
                 if getattr(system, "use_scheduler", False) else None)
        node = state.plan.node
        attempt = 0
        while True:
            try:
                engine.admit(state, handle)
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
            return

    def fail_node(self, node: int) -> None:
        self.system.fail_node(node)

    def join_node(self, *, speed: float = 1.0,
                  capacity: Optional[int] = None) -> int:
        """Grow the fleet by one fresh node (``CacheGenius.join_node``);
        returns its index.  Safe between groups."""
        return self.system.join_node(speed=speed, capacity=capacity)

    def tagged_stats(self) -> Dict[Tuple[Optional[str], Optional[str]],
                                   Dict[str, float]]:
        """Per-(tenant, tier) latency percentiles over everything this
        engine has completed (empty when traffic is untagged) — see
        :func:`tenant_tier_stats`."""
        return tenant_tier_stats(self.completed)


def tenant_tier_stats(completed: Sequence[Completed],
                      ) -> Dict[Tuple[Optional[str], Optional[str]],
                                Dict[str, float]]:
    """Queue-delay and wall-latency percentiles per (tenant, tier).

    Groups tagged completions (requests whose ``tenant`` or ``tier`` is
    set) and reports, per group: ``n``, ``queue_delay_p50/p95``,
    ``wall_p50/p95`` (per-request measured pipeline wall ``wall_total``,
    falling back to the batch-amortised ``wall_latency`` when a caller
    built results without stage timestamps) and ``e2e_p50/p95``
    (queue delay + wall).  Untagged completions are skipped; fully
    untagged traffic returns ``{}``, which is the "don't print the
    table" signal the serve CLI keys on.
    """
    groups: Dict[Tuple[Optional[str], Optional[str]], List[Completed]] = {}
    for c in completed:
        if c.request.tenant is None and c.request.tier is None:
            continue
        groups.setdefault((c.request.tenant, c.request.tier), []).append(c)
    out: Dict[Tuple[Optional[str], Optional[str]], Dict[str, float]] = {}
    for key in sorted(groups, key=lambda k: (str(k[0]), str(k[1]))):
        cs = groups[key]
        qd = np.array([c.queue_delay for c in cs])
        wall = np.array([c.result.wall_total if c.result.wall_total > 0
                         else c.result.wall_latency for c in cs])
        e2e = qd + wall
        out[key] = {
            "n": len(cs),
            "queue_delay_p50": float(np.percentile(qd, 50)),
            "queue_delay_p95": float(np.percentile(qd, 95)),
            "wall_p50": float(np.percentile(wall, 50)),
            "wall_p95": float(np.percentile(wall, 95)),
            "e2e_p50": float(np.percentile(e2e, 50)),
            "e2e_p95": float(np.percentile(e2e, 95)),
        }
    return out
