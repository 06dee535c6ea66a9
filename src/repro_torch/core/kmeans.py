"""K-means — substrate of the storage classifier (paper §IV-C); the port
of the JAX package's ``repro/core/kmeans.py``.

Lloyd's algorithm from a deterministic farthest-point seed (k-means++
flavoured, no sampling), so the node assignments match the JAX package's
exactly on the same data.  The JAX version runs both loops under
``lax.scan``; here they are Python loops over tensors on ``x``'s device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansState(NamedTuple):
    centroids: torch.Tensor   # (k, d)
    assignment: torch.Tensor  # (n,) int32
    inertia: torch.Tensor     # () — within-cluster sum of squared errors


def _pairwise_sqdist(x, c):
    """(n, d) x (k, d) -> (n, k) squared euclidean distances."""
    x2 = x.square().sum(dim=-1, keepdim=True)
    c2 = c.square().sum(dim=-1)
    return x2 - 2.0 * (x @ c.T) + c2[None, :]


def kmeans_assign(x, centroids):
    """Nearest-centroid assignment (first centroid on ties).  Returns
    (assignment, sq_distance)."""
    d = _pairwise_sqdist(x, centroids)
    return torch.argmin(d, dim=-1).to(torch.int32), d.min(dim=-1).values


def _seed_farthest_point(x, k: int):
    """Deterministic farthest-point seeding (first point on ties)."""
    cents = torch.zeros((k, x.shape[-1]), dtype=x.dtype, device=x.device)
    cents[0] = x[0]
    mind = (x - x[0][None, :]).square().sum(dim=-1)
    for count in range(1, k):
        nxt = torch.argmax(mind)
        cents[count] = x[nxt]
        mind = torch.minimum(mind, (x - x[nxt][None, :]).square().sum(dim=-1))
    return cents


def kmeans_fit(x, *, k: int, iters: int = 25) -> KMeansState:
    """Lloyd's algorithm. x: (n, d). Empty clusters keep their centroid."""
    x = x.float()
    cents = _seed_farthest_point(x, k)
    for _ in range(iters):
        idx, _ = kmeans_assign(x, cents)
        onehot = torch.nn.functional.one_hot(idx.long(), k).float()  # (n, k)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ x
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp(min=1.0)[:, None], cents)
    idx, dmin = kmeans_assign(x, cents)
    return KMeansState(centroids=cents, assignment=idx, inertia=dmin.sum())
