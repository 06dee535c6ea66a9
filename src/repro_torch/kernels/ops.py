"""Device dispatch for the kernels of the serving path.

A CPU tensor takes the plain PyTorch version (:mod:`.ref`); a CUDA
tensor launches the hand-written kernel, which raises on what it cannot
take.  There is no fallback from a kernel to its plain version: on the
card the path either runs the kernel or fails.
"""
from __future__ import annotations

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
