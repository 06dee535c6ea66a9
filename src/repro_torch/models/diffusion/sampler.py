"""DDIM (Eq. 3), the SDEdit start (Eq. 4), the latent-depth resume, the
ragged slot step and rectified flow (Flux) — the JAX package's
``repro/models/diffusion/sampler.py`` without its training losses.

The JAX sampler runs the step loop under ``lax.scan``; here it is a
Python loop (PyTorch runs eagerly), shared by every DDIM chain through
:func:`_ddim_scan`.  ``ddim_timesteps`` stays host numpy, as in the JAX
package, and so does ``rf_timesteps`` (the JAX package's is an f32
``jnp.linspace``; the numpy here repeats XLA's arithmetic, see there).
Noise comes from an explicit ``torch.Generator`` or an injected tensor.
"""
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.diffusion.schedule import DiffusionSchedule


def ddim_timesteps(T: int, steps: int, *, t_start: Optional[int] = None):
    """Strided DDIM sub-sequence, descending.  ``t_start`` truncates the
    chain for SDEdit (start at noise level t_start instead of T)."""
    hi = T if t_start is None else int(t_start)
    ts = np.linspace(0, hi - 1, steps).round().astype(np.int32)
    return ts[::-1]


def ddim_step(sched: DiffusionSchedule, x, eps, t: int, t_prev: int):
    """One deterministic DDIM update (Eq. 3, eta = 0); ``t_prev < 0``
    marks the chain's last step (alpha-bar 1)."""
    ab_t = sched.alphas_bar[t]
    ab_p = (sched.alphas_bar[t_prev] if t_prev >= 0
            else torch.ones((), dtype=ab_t.dtype, device=ab_t.device))
    return _ddim_update(x, eps, ab_t, ab_p)


def _ddim_update(x, eps, ab_t, ab_p):
    """Eq. 3 from the alpha-bars at ``t`` and at the next timestep
    (scalars, or per-element tensors broadcast over the latent axes)."""
    x0_pred = (x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
    x0_pred = x0_pred.clamp(-4.0, 4.0)
    dir_xt = torch.sqrt(torch.clamp(1.0 - ab_p, min=0.0)) * eps
    return torch.sqrt(ab_p) * x0_pred + dir_xt


def ddim_step_slots(sched: DiffusionSchedule, x, eps, t, t_prev):
    """One DDIM update with PER-ELEMENT timesteps: ``t`` and ``t_prev``
    are (B,) int tensors, so every batch element can sit at a different
    point of a different-length chain.  Same arithmetic as
    :func:`ddim_step`; ``t_prev < 0`` marks an element's last update
    (alpha-bar 1)."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    t, t_prev = t.long(), t_prev.long()
    ab_t = sched.alphas_bar[t].reshape(shape)
    ab_p = torch.where(t_prev >= 0, sched.alphas_bar[t_prev.clamp(min=0)],
                       torch.ones((), dtype=ab_t.dtype, device=ab_t.device))
    return _ddim_update(x, eps, ab_t, ab_p.reshape(shape))


def step_slots(eps_fn: Callable, sched: DiffusionSchedule, x, ctx, t,
               t_prev, active):
    """ONE denoising step over a ragged slot buffer: ``x`` (S, ...) the
    slot latents, ``ctx`` their conditioning, ``t``/``t_prev`` (S,) each
    slot's own timesteps and ``active`` an (S,) bool mask.  Every slot
    runs through the network; inactive slots come back unchanged."""
    eps = eps_fn(x, t, ctx)
    x_new = ddim_step_slots(sched, x, eps, t, t_prev).float()
    mask = active.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x_new, x)


def _ddim_scan(eps_fn: Callable, sched: DiffusionSchedule, x, ctx, ts):
    """The shared DDIM step loop over an explicit descending timestep
    vector, whether the chain is full, truncated (SDEdit) or resumed
    mid-way (the latent-depth cache)."""
    ts_prev = list(ts[1:]) + [-1]
    b = x.shape[0]
    for t, t_prev in zip(ts, ts_prev):
        t_b = torch.full((b,), int(t), dtype=torch.int32, device=x.device)
        eps = eps_fn(x, t_b, ctx)
        x = ddim_step(sched, x, eps, int(t), int(t_prev)).float()
    return x


def ddim_sample(eps_fn: Callable, sched: DiffusionSchedule, shape, ctx, *,
                steps: int, generator: Optional[torch.Generator] = None,
                x_init=None, t_start: Optional[int] = None):
    """DDIM sampling loop.

    Text-to-image: x_init=None -> start from N(0, I) drawn from
    ``generator`` at t=T.  SDEdit: pass x_init = q_sample(reference,
    t_start) and t_start < T."""
    if x_init is None:
        x = torch.randn(shape, generator=generator, device=ctx.device)
    else:
        x = x_init
    return _ddim_scan(eps_fn, sched, x, ctx,
                      ddim_timesteps(sched.T, steps, t_start=t_start))


def sdedit_start(sched: DiffusionSchedule, reference, noise, *,
                 strength: float):
    """The SDEdit noising map (Eq. 4): noise ``reference`` to
    t = strength·(T-1) with the given ``noise`` draw.  Returns
    ``(x_init, t_start)`` where ``t_start`` is the DDIM chain's
    truncation point."""
    t_noise = int(strength * (sched.T - 1))
    t = torch.full((reference.shape[0],), t_noise, dtype=torch.long,
                   device=reference.device)
    x_init = sched.q_sample(reference.float(), t, noise)
    return x_init.float(), int(strength * sched.T)


def resume_noise_levels(sched: DiffusionSchedule, *, steps: int,
                        strength: float):
    """Forward-noise level (schedule timestep) of each depth of the
    truncated img2img chain — the latent-depth cache's archive map.
    Level 0 is :func:`sdedit_start`'s ``strength·(T-1)``, so a depth-0
    resume replays the full img2img chain; level k >= 1 is ``ts[k]``."""
    ts = ddim_timesteps(sched.T, steps, t_start=int(strength * sched.T))
    return ([int(strength * (sched.T - 1))]
            + [int(ts[k]) for k in range(1, steps)])


def resume_sample(eps_fn: Callable, sched: DiffusionSchedule, latent, ctx,
                  *, steps: int, k: int, strength: float = 0.6):
    """Run the last ``steps - k`` updates of the ``steps``-step img2img
    chain from an archived latent noised to
    ``resume_noise_levels(...)[k]``; ``k == 0`` is the full img2img
    chain from the SDEdit initial state."""
    ts = ddim_timesteps(sched.T, steps, t_start=int(strength * sched.T))
    return _ddim_scan(eps_fn, sched, latent.float(), ctx, ts[k:])


# ---------------------------------------------------------------------------
# rectified flow (Flux-class MMDiT)
# ---------------------------------------------------------------------------


def rf_timesteps(steps: int, *, t_start: float = 1.0, shift: float = 1.0):
    """Descending σ ∈ (t_start .. 0] as ``steps + 1`` float32 values;
    ``shift`` is Flux's resolution-dependent time-shift
    s·t / (1 + (s-1)·t).  The JAX package's ``jnp.linspace(t_start, 0,
    steps + 1)`` as XLA evaluates it on the host: t_start·(1 - i·(1/steps))
    in float32 (the division by the constant becomes a product with its
    reciprocal), the last value 0 — bit for bit below 352 steps, and
    within 3e-7 beyond, where XLA's generated loop rounds otherwise."""
    f32 = np.float32
    step = np.arange(steps, dtype=f32) * (f32(1.0) / f32(steps))
    t = np.concatenate([f32(t_start) * (f32(1.0) - step),
                        np.zeros(1, f32)]).astype(f32)
    if shift != 1.0:
        t = f32(shift) * t / (f32(1.0) + f32(shift - 1.0) * t)
    return t


def rf_sample(v_fn: Callable, shape, ctx, *, steps: int, shift: float = 1.0,
              x_init=None, t_start: float = 1.0, dtype=torch.float32,
              generator: Optional[torch.Generator] = None, device=None):
    """Euler integration of dx/dt = v(x, t) from ``t_start`` down to 0.
    ``v_fn(x, t, ctx)`` predicts the velocity (x1 - x0 direction).
    ``x_init=None`` starts from N(0, I) drawn from ``generator`` on
    ``device``.

    Each update is the JAX package's type promotion: ``ts`` is float32,
    so ``x + (t_nxt - t_cur) * v`` is computed in float32 whatever x's
    dtype and cast back to it (PyTorch would not promote a 0-dim float32
    against a bf16 tensor); the network sees t rounded to x's dtype."""
    if x_init is None:
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
    else:
        x = x_init
    ts = rf_timesteps(steps, t_start=t_start, shift=shift)
    for i in range(steps):
        t_b = torch.full((shape[0],), float(ts[i]), dtype=dtype,
                         device=x.device)
        v = v_fn(x, t_b, ctx)
        dt = torch.tensor(ts[i + 1] - ts[i], dtype=torch.float32,
                          device=x.device)
        x = (x.float() + dt * v.float()).to(dtype)
    return x


def rf_edit(v_fn: Callable, reference, ctx, *, steps: int,
            strength: float = 0.6, shift: float = 1.0, dtype=torch.float32,
            noise=None, generator: Optional[torch.Generator] = None):
    """Rectified-flow SDEdit analogue: start at the straight-line
    interpolant x_t = (1-t)·ref + t·ε with t = strength, integrate down.
    ``noise`` is ε (reference's shape), or None to draw it from
    ``generator`` on the reference's device.  The interpolant's scalars
    round to ``dtype`` first, as JAX's weakly typed Python floats do."""
    if noise is None:
        noise = torch.randn(reference.shape, generator=generator,
                            dtype=dtype, device=reference.device)
    dev = reference.device
    t0 = strength
    x_init = (torch.tensor(1.0 - t0, dtype=dtype, device=dev)
              * reference.to(dtype)
              + torch.tensor(t0, dtype=dtype, device=dev) * noise.to(dtype))
    return rf_sample(v_fn, reference.shape, ctx, steps=steps, shift=shift,
                     x_init=x_init, t_start=t0, dtype=dtype)
