"""Step builders: one program per (architecture × shape) cell — the
port of the JAX package's ``repro/runtime/steps.py`` for diffusion
``gen`` cells.

``build_cell_program(arch, cell)`` returns a :class:`CellProgram` whose
``step_fn`` is ONE denoising step of the sampler (DDIM for eps-models,
Euler for rectified flow); the sampler multiplies it by ``cell.steps``,
and CacheGenius's routing changes that multiplier (N → K → 0).
``init_fn(seed)`` builds the network on the program's device in the
cell's dtype (bf16 for flux-dev at full size, f32 reduced), and
``arg_shapes`` gives the step's input shapes and dtypes.

The port is single-controller: no partition specs, no mesh, no
``options`` (the JAX package's TPU layout variants).  Train, prefill,
decode and infer cells, and the UNet backbone, are not ported yet and
raise an error that says so.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.configs.shapes import ShapeCell
from repro_torch.models.diffusion.dit import DiT
from repro_torch.models.diffusion.mmdit import MMDiT
from repro_torch.models.diffusion.sampler import ddim_step
from repro_torch.models.diffusion.schedule import DiffusionSchedule


@dataclass
class CellProgram:
    arch: ArchSpec
    cell: ShapeCell
    step_fn: Callable        # (net, x, t, t_prev, ctx) -> x after one step
    init_fn: Callable        # seed -> the network on the program's device
    # the step's inputs after ``net``: x, t, t_prev, ctx as (shape, dtype),
    # ctx a dict of them for the MMDiT
    arg_shapes: Tuple[Any, ...]
    meta: Dict[str, Any] = field(default_factory=dict)


def _dtype_of(arch: ArchSpec) -> torch.dtype:
    return torch.bfloat16 if arch.param_dtype == "bfloat16" else torch.float32


def _reduce_cell(cell: ShapeCell) -> ShapeCell:
    """Shrink a gen cell's shapes for the CPU tests (same kind/flow), as
    the JAX package does."""
    return replace(cell, global_batch=2, img_res=32, shard_spatial=False)


def _ctx_shapes(dcfg, batch: int, dtype):
    if dcfg.backbone == "dit":
        return ((batch, dcfg.net.ctx_dim), dtype)
    return {"txt": ((batch, dcfg.net.txt_len, dcfg.net.txt_dim), dtype),
            "vec": ((batch, dcfg.net.vec_dim), dtype)}


def _init_fn(dcfg, dtype, device: torch.device) -> Callable:
    """seed -> the backbone with the JAX package's initialisation, on
    ``device`` in ``dtype``."""
    if dcfg.backbone == "dit":
        def init(seed: int = 0):
            return DiT(dcfg.net, generator=torch.Generator().manual_seed(
                seed)).to(device=device, dtype=dtype).eval()
    else:
        def init(seed: int = 0):
            gen = torch.Generator(device).manual_seed(seed)
            return MMDiT(dcfg.net, device=device, dtype=dtype,
                         generator=gen).eval()
    return init


def _gen_program(arch: ArchSpec, cell: ShapeCell, dcfg, *, reduced: bool,
                 device: torch.device) -> CellProgram:
    if dcfg.backbone not in ("dit", "mmdit"):
        raise NotImplementedError(
            f"the {dcfg.backbone} backbone ({arch.name}) is not ported yet")
    dt = torch.float32 if reduced else _dtype_of(arch)
    sched = DiffusionSchedule.linear(1000, device=device)
    latent = dcfg.net.img_res
    b = cell.global_batch

    if dcfg.backbone == "dit":                          # eps-prediction
        def step_fn(net, x, t, t_prev, ctx):
            eps = net(x, t, ctx)
            return ddim_step(sched, x, eps, int(t[0]),
                             int(t_prev)).to(x.dtype)
    else:                                               # velocity (RF)
        def step_fn(net, x, t, t_prev, ctx):
            # t / T and the Euler step in x's dtype (bf16 at full size:
            # t = 999 rounds to 1000 there), as the JAX program computes
            v = net(x, t.to(x.dtype) / sched.T, ctx)
            dt_ = (t_prev.to(x.dtype) - t[0].to(x.dtype)) / sched.T
            return (x + dt_ * v).to(x.dtype)

    arg_shapes = (((b, latent, latent, dcfg.vae.z_ch), dt),
                  ((b,), torch.int32), ((), torch.int32),
                  _ctx_shapes(dcfg, b, dt))
    return CellProgram(arch, cell, step_fn, _init_fn(dcfg, dt, device),
                       arg_shapes,
                       meta={"latent": latent, "steps": cell.steps,
                             "config": dcfg})


def build_cell_program(arch: ArchSpec, cell: ShapeCell, *,
                       reduced: bool = False,
                       device="cuda") -> CellProgram:
    """The program of one (arch, cell) on ``device`` (the card unless the
    caller asks for the CPU).  ``reduced`` takes the arch's reduced
    config and shrinks the cell, as the JAX package's CPU tests do.  On
    the card it turns TF32 off, as the serving backend does: the port
    holds its float32 kernels to float32 plain versions."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dcfg = arch.make_reduced() if reduced else arch.make_config(cell)
    if reduced:
        cell = _reduce_cell(cell)
    if arch.family_group != "diffusion":
        raise NotImplementedError(
            f"{arch.family} programs ({arch.name}) are not ported yet")
    if cell.kind != "gen":
        raise NotImplementedError(
            f"{cell.kind} cells ({arch.name} {cell.name}) are not ported "
            "yet: the port serves diffusion gen cells")
    return _gen_program(arch, cell, dcfg, reduced=reduced, device=device)
