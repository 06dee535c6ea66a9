"""Serving engine: CacheGenius front end over an eager diffusion backend —
the drain path of the JAX package's ``repro/runtime/serving.py``.

* :class:`DiffusionBackend` — txt2img / img2img over a DiT + VAE on the
  card.  PyTorch runs eagerly, so there is no AOT registry: a group is
  padded to a power-of-two batch (as in the JAX package, so that padding
  rules and per-request results match) and run directly.
* :class:`ServingEngine` — the request queue over the CacheGenius
  orchestrator: ``submit`` + ``drain`` serve everything queued in FIFO
  micro-batches of ``max_batch``.

Continuous batching (``run``), step-level slots and latent resume are
later slices of the port (``DiffusionBackend.supports_latent_resume`` is
False).

Noise: the JAX backend draws each request's initial noise from
``jax.random.split(PRNGKey(seed))``.  The port does not copy threefry; it
takes a ``noise_fn(seeds, shape, device) -> Tensor``.  The default,
:func:`seeded_noise`, draws each element from its own
``torch.Generator`` seeded with the request's seed, so batching never
changes a request's image.  Tests pass the JAX draw instead.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.system import (CacheGenius, GenerationBackend,
                                     ServeResult)
from repro_torch.models.diffusion.dit import DiT, make_eps_fn
from repro_torch.models.diffusion.sampler import ddim_sample, sdedit_start
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


class DiffusionBackend(GenerationBackend):
    """txt2img/img2img over a DiT+VAE.  ``embed_prompt`` maps a prompt to
    the conditioning vector (the proxy CLIP embedder in practice)."""

    supports_latent_resume = False

    def __init__(self, dit: DiT, vae: VAE,
                 embed_prompt: Callable[[str], np.ndarray], *,
                 schedule: Optional[DiffusionSchedule] = None,
                 latent_scale: float = 1.0, img2img_strength: float = 0.6,
                 noise_fn: Optional[Callable] = None, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
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

    def _pad_ctx_seeds(self, prompts: Sequence[str], seeds: Sequence[int],
                       bucket: int):
        """Conditioning rows and seeds padded to ``bucket`` (the last
        prompt repeated, seed 0), as in the JAX package."""
        ctx = np.stack([np.asarray(self.embed_prompt(p), np.float32)
                        for p in prompts])
        pad = bucket - len(prompts)
        if pad:
            ctx = np.concatenate([ctx, np.repeat(ctx[-1:], pad, axis=0)])
        return (torch.from_numpy(ctx).to(self.device),
                list(seeds) + [0] * pad)

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.image_res, self.image_res, 3), np.float32)

    @torch.inference_mode()
    def txt2img_batch(self, prompts: Sequence[str], steps: int,
                      seeds: Sequence[int]) -> np.ndarray:
        """Batched text-to-image: the group padded to a power of two, one
        DDIM chain, one VAE decode."""
        n = len(prompts)
        if n == 0:
            return self._empty()
        ctx, seeds = self._pad_ctx_seeds(prompts, seeds, next_pow2(n))
        cfg = self.net_cfg
        x_init = self.noise_fn(seeds, (cfg.img_res, cfg.img_res, cfg.in_ch),
                               self.device)
        z = ddim_sample(make_eps_fn(self.dit), self.sched, x_init.shape, ctx,
                        steps=steps, x_init=x_init)
        out = self.vae.decode(z / self.latent_scale)
        return out[:n].cpu().numpy()

    @torch.inference_mode()
    def img2img_batch(self, prompts: Sequence[str], references: np.ndarray,
                      steps: int, seeds: Sequence[int]) -> np.ndarray:
        """Batched SDEdit img2img over stacked references (B, H, W, 3)."""
        n = len(prompts)
        if n == 0:
            return self._empty()
        bucket = next_pow2(n)
        ctx, seeds = self._pad_ctx_seeds(prompts, seeds, bucket)
        refs = np.asarray(references, np.float32)
        if bucket != n:
            refs = np.concatenate(
                [refs, np.repeat(refs[-1:], bucket - n, axis=0)])
        mean, _ = self.vae.encode(torch.from_numpy(refs).to(self.device))
        z_ref = mean * self.latent_scale
        noise = self.noise_fn(seeds, tuple(z_ref.shape[1:]), self.device)
        x_init, t_start = sdedit_start(self.sched, z_ref, noise,
                                       strength=self.strength)
        z = ddim_sample(make_eps_fn(self.dit), self.sched, z_ref.shape, ctx,
                        steps=steps, x_init=x_init, t_start=t_start)
        out = self.vae.decode(z / self.latent_scale)
        return out[:n].cpu().numpy()


# ---------------------------------------------------------------------------
# batched request engine
# ---------------------------------------------------------------------------


@dataclass
class Request:
    prompt: str
    seed: int = 0
    quality_tier: bool = False
    submitted_at: float = 0.0   # time.perf_counter at submit


@dataclass
class Completed:
    request: Request
    result: ServeResult
    queue_delay: float          # seconds actually waited before admission
    finished_at: float = 0.0    # perf_counter instant the result came back


class ServingEngine:
    """Asynchronous-queue semantics (paper §V "asynchronous task queue")
    over ``CacheGenius.serve_batch``: ``submit`` queues a request,
    ``drain`` serves the queue in FIFO micro-batches of ``max_batch``."""

    def __init__(self, system: CacheGenius, *, max_batch: int = 8):
        self.system = system
        self.max_batch = max_batch
        self.queue: List[Request] = []
        self.completed: List[Completed] = []

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

    def fail_node(self, node: int) -> None:
        self.system.fail_node(node)
