"""Input-shape cells per architecture family (40 assigned cells total);
a plain copy of the JAX package's ``repro/configs/shapes.py``.

Every cell names the step it lowers:
  * ``train``    — train_step (forward + backward + optimizer update)
  * ``prefill``  — LM prefill: full-sequence forward returning KV caches
  * ``decode``   — LM serve_step: one new token against a seq_len KV cache
  * ``gen``      — diffusion serve_step: ONE denoising step (the sampler
                   multiplies by ``steps``; that multiplier is exactly where
                   CacheGenius acts: N→K→0)
  * ``infer``    — vision forward pass

``shard_kv`` picks how the decode KV cache is partitioned (DESIGN.md §4):
decode_32k shards the cache sequence over ``model`` (batch over data);
long_500k (batch=1) shards the 524288-long cache over ``data``+``model`` —
the softmax reduction then lowers to an all-reduce: flash-decoding derived
by SPMD instead of hand-written, so full-attention archs run the cell.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                       # train | prefill | decode | gen | infer
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # diffusion / vision fields
    img_res: int = 0
    steps: int = 0                  # sampler step count (gen) / train steps
    # execution knobs
    microbatches: int = 1           # grad-accumulation chunks for train cells
    shard_kv: Optional[str] = None  # None | "model" | "data_model"
    shard_spatial: bool = False     # shard image H dim instead of batch
    notes: str = ""


LM_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256,
              microbatches=16),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128,
              shard_kv="model"),
    ShapeCell("long_500k", "decode", seq_len=524288, global_batch=1,
              shard_kv="data_model",
              notes="KV cache sequence-sharded over data+model; softmax "
                    "reduction = SPMD-derived flash-decoding"),
)

DIFFUSION_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_256", "train", img_res=256, global_batch=256,
              steps=1000, microbatches=1),
    ShapeCell("gen_1024", "gen", img_res=1024, global_batch=4, steps=50,
              shard_spatial=True),
    ShapeCell("gen_fast", "gen", img_res=512, global_batch=16, steps=4),
    ShapeCell("train_1024", "train", img_res=1024, global_batch=32,
              steps=1000, microbatches=2),
)

VISION_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("cls_224", "train", img_res=224, global_batch=256),
    ShapeCell("cls_384", "train", img_res=384, global_batch=64),
    ShapeCell("serve_b1", "infer", img_res=224, global_batch=1,
              shard_spatial=True),
    ShapeCell("serve_b128", "infer", img_res=224, global_batch=128),
)

_BY_FAMILY = {"lm": LM_SHAPES, "diffusion": DIFFUSION_SHAPES,
              "vision": VISION_SHAPES}


def shapes_for_family(family: str) -> Tuple[ShapeCell, ...]:
    key = "lm" if family.startswith("lm") else \
          "vision" if family.startswith("vision") else "diffusion"
    return _BY_FAMILY[key]


def get_shape(family: str, name: str) -> ShapeCell:
    for c in shapes_for_family(family):
        if c.name == name:
            return c
    raise KeyError(f"{family} has no shape {name!r}")
