"""Plain PyTorch versions of every kernel (the port of the JAX package's
``repro/kernels/ref.py``).

They run on any device.  :mod:`repro_torch.kernels.ops` takes them for
CPU tensors; ``chip_smoke.py`` holds each kernel against them on the
card; the CPU tests hold them against the JAX package's oracles.

Top-k order: ``torch.topk`` promises nothing on ties, so the top-k here
is a stable descending sort cut to ``k``, which keeps the lower index
first on equal scores — ``jax.lax.top_k``'s rule.  Masked candidates are
``-inf`` (the CUDA kernel uses the ``-1e30`` sentinel instead; both rank
below every real score and are dropped by the host).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common.layers import groupnorm


def _topk(scores: torch.Tensor, k: int):
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k].to(torch.int32)


def vdb_topk_ref(queries, db, valid, k: int):
    """queries: (Q, D) L2-normalised; db: (N, D); valid: (N,) bool.
    Returns (scores (Q, k), idx (Q, k)) by cosine similarity."""
    scores = queries @ db.T
    scores = torch.where(valid[None, :], scores, float("-inf"))
    return _topk(scores, k)


def vdb_topk_sharded_ref(queries, slabs, valid, node_ids, k: int, *,
                         mask_nodes: bool = True):
    """queries: (Q, D); slabs: (n_idx, nodes, cap, D); valid: (nodes, cap);
    node_ids: (Q,).  Returns (scores, idx) of shape (n_idx, Q, k) with
    GLOBAL slot ids ``node * cap + col``; masked candidates are -inf."""
    n_idx, n_nodes, cap, _ = slabs.shape
    scores = torch.einsum("qd,incd->iqnc", queries, slabs)
    ok = valid[None, None, :, :]
    if mask_nodes:
        nodes = torch.arange(n_nodes, device=slabs.device)
        ok = ok & (node_ids.long()[None, :, None, None]
                   == nodes[None, None, :, None])
    scores = torch.where(ok, scores, float("-inf"))
    flat = scores.reshape(n_idx, scores.shape[1], n_nodes * cap)
    return _topk(flat, k)


def vdb_topk_pernode_ref(queries, slabs, valid, k: int):
    """Every query's top-k within EVERY node's slab.  queries: (Q, D);
    slabs: (n_idx, nodes, cap, D); valid: (nodes, cap).  Returns (scores,
    idx) of shape (n_idx, nodes, Q, k) with GLOBAL slot ids
    ``node * cap + col``; masked candidates are -inf."""
    n_idx, n_nodes, cap, _ = slabs.shape
    scores = torch.einsum("qd,incd->inqc", queries, slabs)
    scores = torch.where(valid[None, :, None, :], scores, float("-inf"))
    s, col = _topk(scores, k)
    offset = (torch.arange(n_nodes, device=slabs.device, dtype=torch.int32)
              * cap)[None, :, None, None]
    return s, col + offset


def flash_attention_ref(q, k, v, *, causal: bool = False):
    """q: (B, Sq, H, D); k/v: (B, Sk, H, D) -> (B, Sq, H, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, -1e30)
    probs = F.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def adaln_modulate_ref(x, shift, scale, *, eps: float = 1e-5):
    """Fused LN(affine-free) + adaLN modulation.
    x: (B, T, D); shift/scale: (B, D)."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + eps)
    y = xn * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return y.to(dtype)


def groupnorm_silu_ref(x, scale, bias, *, groups: int = 32,
                       eps: float = 1e-5):
    """silu(groupnorm(x) * scale + bias); x: (B, H, W, C) NHWC, scale/bias
    (C,).  Group statistics in f32 over (H, W, C/G), two-pass; the group
    count shrinks until it divides C."""
    return F.silu(groupnorm(x, scale, bias, groups=groups, eps=eps))
