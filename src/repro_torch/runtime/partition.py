"""How the cluster index splits its node axis over a node mesh — the
cluster part of the JAX package's ``repro/runtime/partition.py``.

The reference shards the ``(2, padded_nodes, capacity, dim)`` slabs and
the ``(padded_nodes, capacity)`` validity along the node axis
(``CLUSTER_SLAB_SPEC``, ``CLUSTER_VALID_SPEC``): index planes, slot rows
and feature dims stay whole on every device.  The port keeps one tensor
pair per shard, each on its shard's device, so the split is plain index
arithmetic: the node axis pads up to a multiple of the mesh with nodes
that are never valid, and shard s holds the ``nodes_per_shard``
consecutive nodes from ``s * nodes_per_shard``.

The rules for model parameters and optimiser state (``spec_for``,
``tree_specs``, ``fsdp_specs``, ...) belong to training and are not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

# the node axis of the slabs (planes, nodes, capacity, dim) and of the
# validity (nodes, capacity)
SLAB_NODE_AXIS = 1
VALID_NODE_AXIS = 0


def padded_nodes(n_nodes: int, mesh_nodes: int) -> int:
    """The node axis the mesh holds: ``n_nodes`` without a mesh, else
    ``ceil(max(n_nodes, 1) / mesh_nodes) * mesh_nodes`` (the reference's
    rule; a fleet of no node still gives every shard one pad node)."""
    if mesh_nodes == 1:
        return n_nodes
    return -(-max(n_nodes, 1) // mesh_nodes) * mesh_nodes


def owner(node: int, per_shard: int) -> Tuple[int, int]:
    """(shard, node within the shard) of a global node id."""
    return divmod(node, per_shard)


def device_bytes(tensors: Iterable[torch.Tensor]) -> Dict[torch.device, int]:
    """Bytes resident on each device over ``tensors``."""
    out: Dict[torch.device, int] = {}
    for t in tensors:
        out[t.device] = out.get(t.device, 0) + t.numel() * t.element_size()
    return out
