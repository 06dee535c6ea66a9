"""Latency (Eq. 8) and $ cost models.

    L_i = t_retrieve + x_i * t_return + y_i * (t_noise + K * t_step)
                     + z_i * N * t_step

with exactly one of x, y, z set per request (direct return / img2img /
txt2img).  ``t_step`` is per-node (heterogeneous GPUs in the paper; on TPU
we derive it from the roofline terms of the compiled denoise step).

Per-depth extension (the latent-depth cache): an img2img request resumed
from an archived depth-k latent replaces ``t_noise`` (the latent is
pre-noised at archive time) with ``t_latent`` (fetching the latent blob)
and runs only the remaining chain:

    L_k = t_retrieve + t_latent + (K - k) * t_step

so ``latency(Route.IMG2IMG, K - k, resumed=True)`` prices depth k.

The cost model mirrors the paper's AutoDL accounting: GPU-hours at per-node
rates + a flat VDB rate, aggregated over a task stream (Fig. 17).  Fleets
larger than the rate vector must pass explicit per-node rates — only the
paper's default 4-node AutoDL vector recycles by modulo.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from repro_torch.core.policy import Route


@dataclass
class LatencyModel:
    t_retrieve: float = 0.050   # VDB query
    t_return: float = 0.020     # ship cached image to the user
    t_noise: float = 0.005      # SDEdit forward noising (Eq. 4)
    t_latent: float = 0.015     # fetch an archived depth-k latent blob
    t_step: float = 0.060       # per denoising step (node-speed scaled)
    t_schedule: float = 0.002   # Eq. 6 node matching
    t_embed: float = 0.008      # CLIP encode of the prompt

    def latency(self, route: Route, steps: int, *, node_speed: float = 1.0,
                scheduled: bool = True, retrieved: bool = True,
                resumed: bool = False) -> float:
        t = self.t_embed + (self.t_schedule if scheduled else 0.0)
        t += self.t_retrieve if retrieved else 0.0
        step = self.t_step / max(node_speed, 1e-9)
        if route is Route.HIT_RETURN:
            return t + self.t_return
        if route is Route.IMG2IMG:
            if resumed:
                # per-depth Eq. 8: the archived latent is already noised, so
                # t_noise is replaced by the latent fetch and only the
                # remaining K - k steps run (callers pass steps = K - k)
                return t + self.t_latent + steps * step
            return t + self.t_noise + steps * step
        return t + steps * step

    @classmethod
    def from_roofline(cls, step_seconds: float, *, retrieve_seconds: float = 0.01,
                      ) -> "LatencyModel":
        """Build a TPU latency model from the dry-run's per-step roofline time."""
        return cls(t_retrieve=retrieve_seconds, t_step=step_seconds,
                   t_noise=step_seconds * 0.05, t_return=0.005)


# the paper's 4-node AutoDL fleet — the ONLY rate vector that silently
# recycles by modulo for larger fleets (backwards compatibility with the
# paper's experiments; any custom vector must cover every node explicitly)
_DEFAULT_GPU_RATES = (0.28, 0.28, 0.23, 0.084)  # 4090D, 4090D, 3090, 2070S


@dataclass
class CostModel:
    """Per-hour rates (paper's AutoDL numbers, $/h)."""

    gpu_rates: Sequence[float] = _DEFAULT_GPU_RATES
    vdb_rate: float = 0.12
    accumulated_gpu_s: Dict[int, float] = field(default_factory=dict)
    vdb_busy_s: float = 0.0

    def _rate(self, node: int) -> float:
        rates = tuple(self.gpu_rates)
        if 0 <= node < len(rates):
            return rates[node]
        if rates == _DEFAULT_GPU_RATES:
            return rates[node % len(rates)]
        raise ValueError(
            f"node {node} has no rate in gpu_rates (len {len(rates)}); "
            "pass one rate per node for fleets larger than the paper's "
            "default 4-node AutoDL configuration")

    def charge(self, node: int, gpu_seconds: float, vdb_seconds: float = 0.0) -> None:
        self._rate(node)  # validate eagerly, not at total_cost time
        self.accumulated_gpu_s[node] = self.accumulated_gpu_s.get(node, 0.0) + gpu_seconds
        self.vdb_busy_s += vdb_seconds

    def total_cost(self, *, vdb_wall_s: Optional[float] = None) -> float:
        gpu = sum(self._rate(n) * s / 3600.0
                  for n, s in self.accumulated_gpu_s.items())
        vdb_s = self.vdb_busy_s if vdb_wall_s is None else vdb_wall_s
        return gpu + self.vdb_rate * vdb_s / 3600.0
