"""DDPM noise schedule (Eq. 1-2) and the SDEdit forward map (Eq. 4) — the
port of the JAX package's ``repro/models/diffusion/schedule.py``."""
from typing import NamedTuple

import torch


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor          # (T,)
    alphas: torch.Tensor         # (T,)
    alphas_bar: torch.Tensor     # (T,) cumulative alpha-bar

    @property
    def T(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def linear(cls, T: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02, *,
               device="cuda") -> "DiffusionSchedule":
        betas = torch.linspace(beta_start, beta_end, T, dtype=torch.float32,
                               device=device)
        alphas = 1.0 - betas
        return cls(betas, alphas, torch.cumprod(alphas, dim=0))

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(a.to(device) for a in self))

    def q_sample(self, x0, t, noise):
        """Eq. 4: x_t = sqrt(ab_t) x_0 + sqrt(1-ab_t) eps — also the
        SDEdit noising map.  t: (B,) int tensor."""
        ab = self.alphas_bar[t].reshape((-1,) + (1,) * (x0.dim() - 1))
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise
