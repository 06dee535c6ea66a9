"""DDIM (Eq. 3) and the SDEdit start (Eq. 4) — the subset of the JAX
package's ``repro/models/diffusion/sampler.py`` the serving path runs.

The JAX sampler runs the step loop under ``lax.scan``; here it is a
Python loop (PyTorch runs eagerly).  ``ddim_timesteps`` stays host
numpy, as in the JAX package.
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
    x0_pred = (x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
    x0_pred = x0_pred.clamp(-4.0, 4.0)
    dir_xt = torch.sqrt(torch.clamp(1.0 - ab_p, min=0.0)) * eps
    return torch.sqrt(ab_p) * x0_pred + dir_xt


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
    ts = ddim_timesteps(sched.T, steps, t_start=t_start)
    ts_prev = list(ts[1:]) + [-1]
    b = x.shape[0]
    for t, t_prev in zip(ts, ts_prev):
        t_b = torch.full((b,), int(t), dtype=torch.int32, device=x.device)
        eps = eps_fn(x, t_b, ctx)
        x = ddim_step(sched, x, eps, int(t), int(t_prev)).float()
    return x


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
