"""Architecture registry: ``--arch <id>`` resolves here (a copy of the
JAX package's ``repro/configs/registry.py``).

Each ``src/repro_torch/configs/<id>.py`` module defines an
``ARCH: ArchSpec``.  ``make_config(shape)`` returns the family config
tuned for one shape cell (e.g. the latent resolution of a diffusion
cell); ``make_reduced()`` returns a tiny same-family config for CPU
tests.  The port has the ids in ``PORTED_IDS``; any other id of
``ARCH_IDS`` raises an error that names it as not ported yet.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.shapes import ShapeCell, get_shape

ARCH_IDS: Tuple[str, ...] = (
    # LM family
    "llama4-maverick-400b-a17b",
    "moonshot-v1-16b-a3b",
    "qwen3-14b",
    "qwen2-0.5b",
    # diffusion
    "dit-b2",
    "unet-sd15",
    "flux-dev",
    "dit-l2",
    # vision
    "convnext-b",
    "efficientnet-b7",
    # the paper's own CPU-scale reproduction model
    "sd15-small",
)

# the ids whose config modules the port has
PORTED_IDS: Tuple[str, ...] = ("dit-b2", "flux-dev")

_MODULE_OF = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
              for a in PORTED_IDS}


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                       # lm | diffusion-dit | diffusion-unet |
    #                                   diffusion-mmdit | vision-convnext |
    #                                   vision-effnet
    make_config: Callable[[ShapeCell], Any]
    make_reduced: Callable[[], Any]
    shapes: Tuple[str, ...]
    optimizer: str = "adamw"          # adamw | adafactor
    fsdp_params: bool = False         # additionally shard params over data
    param_dtype: str = "float32"      # storage dtype at full scale
    train_microbatches: Optional[int] = None  # override the cell's count
    technique: str = ""               # how CacheGenius applies
    source: str = ""

    @property
    def family_group(self) -> str:
        return ("lm" if self.family.startswith("lm")
                else "vision" if self.family.startswith("vision")
                else "diffusion")

    def cells(self) -> Tuple[ShapeCell, ...]:
        return tuple(get_shape(self.family_group, s) for s in self.shapes)


_cache: Dict[str, ArchSpec] = {}


def get_arch(name: str) -> ArchSpec:
    if name not in _cache:
        if name not in ARCH_IDS:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
        if name not in _MODULE_OF:
            raise NotImplementedError(
                f"arch {name!r} is not ported to repro_torch yet; ported: "
                f"{sorted(PORTED_IDS)}")
        mod = importlib.import_module(_MODULE_OF[name])
        _cache[name] = mod.ARCH
    return _cache[name]
