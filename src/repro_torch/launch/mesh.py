"""The node mesh of the sharded cluster index — the port of
``make_node_mesh`` in the JAX package's ``repro/launch/mesh.py``.

The reference puts the cluster slabs on a 1-D ``("nodes",)`` device mesh
and scans each shard inside ``shard_map``: one process drives every
device, and the per-shard best-k lists come back to the host, where they
are merged.  The port keeps that design.  A :class:`NodeMesh` is the
list of devices that hold one shard each; the cluster index launches
each shard's scan on its own device from the one process
(:func:`repro_torch.kernels.ops.vdb_topk_sharded_mesh`) and merges on
the host.  No collective runs: the "all-gather" is the copy of each
shard's lists to the host, as in the reference.

A device may appear more than once: one card then holds several shards
and runs their scans one after the other, which is how one card runs a
mesh.  On the CPU every shard is ``cpu``, the counterpart of the host
devices the reference forces with ``ensure_host_devices``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class NodeMesh:
    """One device per shard of the node axis, in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"nodes": len(self.devices)}


def make_node_mesh(mesh_nodes: int, device="cuda",
                   devices: Optional[Sequence] = None) -> NodeMesh:
    """A mesh of ``mesh_nodes`` shards.  With ``devices`` given, shard s
    lives on ``devices[s]`` (a card may repeat); else on ``cpu`` for every
    shard where ``device`` is the CPU, and on cards 0 .. mesh_nodes-1
    where it is CUDA.  Raises ``ValueError`` for ``mesh_nodes < 1``, for
    a ``devices`` list of another length, and where the process sees
    fewer cards than the mesh needs (the reference's raise when the
    backend has fewer devices)."""
    if mesh_nodes < 1:
        raise ValueError(f"mesh_nodes must be >= 1, got {mesh_nodes}")
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) != mesh_nodes:
            raise ValueError(f"mesh_nodes={mesh_nodes} needs as many "
                             f"devices, got {len(devs)}")
        return NodeMesh(devs)
    kind = torch.device(device).type
    if kind == "cpu":
        return NodeMesh((torch.device("cpu"),) * mesh_nodes)
    if kind != "cuda":
        raise ValueError(f"no node mesh on {kind} devices")
    avail = torch.cuda.device_count()
    if avail < mesh_nodes:
        raise ValueError(
            f"mesh_nodes={mesh_nodes} needs that many cards, the process "
            f"sees {avail}; pass devices= to put several shards on one card")
    return NodeMesh(tuple(torch.device("cuda", i)
                          for i in range(mesh_nodes)))
