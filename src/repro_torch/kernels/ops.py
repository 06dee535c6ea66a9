"""Device dispatch for the kernels of the serving path.

A CPU tensor takes the plain PyTorch version (:mod:`.ref`); a CUDA
tensor launches the hand-written kernel, which raises on what it cannot
take.  There is no fallback from a kernel to its plain version: on the
card the path either runs the kernel or fails.

The node mesh's scans (``vdb_topk_sharded_mesh``,
``vdb_topk_pernode_mesh``) dispatch K2 or K1 once per shard, each on its
shard's device, and ``merge_shard_topk`` merges their lists on the host;
they hold no kernel of their own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def vdb_topk(queries, db, valid, k: int):
    """(Q, k) single-slab top-k; see ``ref.vdb_topk_ref``."""
    if _on_cpu(queries):
        return ref.vdb_topk_ref(queries, db, valid, k)
    from repro_torch.kernels import vdb_topk as scan
    return scan.launch_single(queries, db, valid, k)


def vdb_topk_pernode(queries, slabs, valid, k: int):
    """(n_idx, nodes, Q, k) per-node top-k; see ``ref.vdb_topk_pernode_ref``."""
    if _on_cpu(queries):
        return ref.vdb_topk_pernode_ref(queries, slabs, valid, k)
    from repro_torch.kernels import vdb_topk
    return vdb_topk.launch_pernode(queries, slabs, valid, k)


def vdb_topk_sharded(queries, slabs, valid, node_ids, k: int, *,
                     mask_nodes: bool = True):
    """(n_idx, Q, k) cluster-wide top-k; see ``ref.vdb_topk_sharded_ref``."""
    if _on_cpu(queries):
        return ref.vdb_topk_sharded_ref(queries, slabs, valid, node_ids, k,
                                        mask_nodes=mask_nodes)
    from repro_torch.kernels import vdb_topk
    return vdb_topk.launch_sharded(queries, slabs, valid, node_ids, k,
                                   mask_nodes=mask_nodes)


def _on_devices(t: torch.Tensor, shards):
    """``t`` on each shard's device, one copy per distinct device."""
    copies = {}
    for slabs, _ in shards:
        if slabs.device not in copies:
            copies[slabs.device] = t.to(slabs.device)
    return [copies[slabs.device] for slabs, _ in shards]


def vdb_topk_sharded_mesh(queries, shards, node_ids, k: int, *,
                          mask_nodes: bool = True, use_pallas: bool = True):
    """The cluster-wide scan over a node mesh (the reference's
    ``vdb_topk_sharded_mesh``).  ``shards``: one ``(slabs, valid)`` pair
    per shard, ``(P, n_shard, cap, D)`` and ``(n_shard, cap)`` on the
    shard's device, shard s holding nodes ``s * n_shard ..``;
    ``node_ids``: (Q,) global node ids (ignored when ``mask_nodes`` is
    false).  Every shard's K2 is launched on its own device before any
    list is read back, so shards on different cards scan at once.  Node
    ids become shard-local: a query whose node lives on another shard
    gets that shard's masked fill.  ``use_pallas=False`` takes the plain
    version on every device.

    Returns the stacked per-shard lists on the host, numpy
    ``(shards, P, Q, k)`` scores and GLOBAL slot ids ``node * cap + col``
    — what the reference's all-gather moves; reduce them with
    :func:`merge_shard_topk`."""
    scan = vdb_topk_sharded if use_pallas else ref.vdb_topk_sharded_ref
    n_shard, cap = shards[0][1].shape
    nids = np.asarray(node_ids, np.int32)
    # every input on its device first: a blocking copy to a card waits
    # for the work queued there, and would wait for an earlier shard
    local = [torch.from_numpy(nids - s * n_shard).to(slabs.device)
             for s, (slabs, _) in enumerate(shards)]
    out = [scan(q, slabs, valid, nid, k, mask_nodes=mask_nodes)
           for q, nid, (slabs, valid) in
           zip(_on_devices(queries, shards), local, shards)]
    return _gather(out, n_shard * cap, axis=0)


def vdb_topk_pernode_mesh(queries, shards, k: int, *,
                          use_pallas: bool = True):
    """The per-node scan over a node mesh (the reference's
    ``vdb_topk_pernode_mesh``): each shard's K1 on its own device, all
    launched before any is read back.  A node's top-k is whole on its
    shard, so nothing merges: the lists are put back together along the
    node axis, numpy ``(P, padded_nodes, Q, k)`` with GLOBAL slot ids —
    for the real nodes exactly what one device's K1 gives."""
    scan = vdb_topk_pernode if use_pallas else ref.vdb_topk_pernode_ref
    n_shard, cap = shards[0][1].shape
    out = [scan(q, slabs, valid, k) for q, (slabs, valid) in
           zip(_on_devices(queries, shards), shards)]
    return _gather(out, n_shard * cap, axis=1)


def _gather(lists, shard_slots: int, axis: int):
    """Shard s's ``(scores, ids)`` to the host, its ids offset by
    ``s * shard_slots`` to global ones; stacked (``axis=0``) or joined
    along the node axis (``axis=1``)."""
    scores, ids = [], []
    for s, (sc, ix) in enumerate(lists):
        scores.append(sc.cpu().numpy())
        ids.append(ix.cpu().numpy() + np.int32(s * shard_slots))
    join = np.stack if axis == 0 else np.concatenate
    kw = {} if axis == 0 else dict(axis=axis)
    return join(scores, **kw), join(ids, **kw)


def merge_shard_topk(scores, idx, k: int):
    """Exact reduction of stacked per-shard lists (the reference's
    ``merge_shard_topk``): ``scores``/``idx`` numpy ``(shards, P, Q,
    k_local)`` with global slot ids -> the ``(P, Q, k)`` top-k, ordered
    by score descending, then global slot ascending — the order of the
    one-device scan, so equal scores on two shards rank as they would
    unsharded."""
    shards, n_idx, qn, kl = scores.shape
    flat_s = np.ascontiguousarray(
        np.transpose(scores, (1, 2, 0, 3))).reshape(n_idx, qn, shards * kl)
    flat_i = np.ascontiguousarray(
        np.transpose(idx, (1, 2, 0, 3))).reshape(n_idx, qn, shards * kl)
    k = min(k, shards * kl)
    order = np.lexsort((flat_i, -flat_s), axis=-1)[..., :k]
    return (np.take_along_axis(flat_s, order, -1),
            np.take_along_axis(flat_i, order, -1))


def flash_attention(q, k, v, *, causal: bool = False):
    """(B, Sq, H, D) attention; see ``ref.flash_attention_ref``."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    from repro_torch.kernels import flash_attention as fa
    return fa.launch(q, k, v, causal=causal)


def adaln_modulate(x, shift, scale):
    """LN(x)·(1 + scale) + shift; see ``ref.adaln_modulate_ref``."""
    if _on_cpu(x):
        return ref.adaln_modulate_ref(x, shift, scale)
    from repro_torch.kernels import adaln
    return adaln.launch(x, shift, scale)


def groupnorm_silu(x, scale, bias, *, groups: int = 32, eps: float = 1e-5):
    """silu(groupnorm(x)·scale + bias) over NHWC; see
    ``ref.groupnorm_silu_ref``."""
    if _on_cpu(x):
        return ref.groupnorm_silu_ref(x, scale, bias, groups=groups, eps=eps)
    from repro_torch.kernels import groupnorm_silu as gn
    return gn.launch(x, scale, bias, groups=groups, eps=eps)
