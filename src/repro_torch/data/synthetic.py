"""Procedural captioned-image corpus (stands in for COCO/DiffusionDB/Flickr30k).

Scenes are parameterised by (shape, color, background, size, position); each
spec renders deterministically to an image and captions deterministically to
a natural-language template.  Crucially the caption is *parseable back* to
the spec, which gives the offline CLIP proxy its cross-modal alignment: the
text tower renders the parsed caption and embeds the canonical render.

The structural-similarity property the paper leans on ("a bird and an
airplane might share a reference despite unrelated semantics") is modelled
by shapes sharing layout: e.g. 'ring' and 'circle' at the same position
have nearly identical structure but different captions.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

SHAPES = ("circle", "square", "triangle", "cross", "ring")
COLORS = {
    "red": (1.0, -0.7, -0.7), "green": (-0.7, 1.0, -0.7), "blue": (-0.7, -0.7, 1.0),
    "yellow": (1.0, 1.0, -0.7), "purple": (0.6, -0.7, 1.0), "orange": (1.0, 0.2, -0.8),
    "white": (1.0, 1.0, 1.0), "cyan": (-0.7, 1.0, 1.0),
}
BACKGROUNDS = {
    "black": (-1.0, -1.0, -1.0), "gray": (0.0, 0.0, 0.0), "navy": (-0.8, -0.8, -0.2),
    "olive": (-0.2, -0.2, -0.8), "maroon": (-0.2, -0.8, -0.8), "teal": (-0.8, -0.2, -0.2),
}
SIZES = {"small": 0.18, "medium": 0.3, "large": 0.42}
POSITIONS = {"left": (-0.4, 0.0), "center": (0.0, 0.0), "right": (0.4, 0.0)}


@dataclass(frozen=True)
class SceneSpec:
    shape: str = "circle"
    color: str = "red"
    background: str = "black"
    size: str = "medium"
    position: str = "center"

    def key(self) -> Tuple[str, str, str, str, str]:
        return (self.shape, self.color, self.background, self.size, self.position)


def random_spec(rng: np.random.Generator) -> SceneSpec:
    return SceneSpec(
        shape=rng.choice(SHAPES),
        color=rng.choice(list(COLORS)),
        background=rng.choice(list(BACKGROUNDS)),
        size=rng.choice(list(SIZES)),
        position=rng.choice(list(POSITIONS)),
    )


def caption_of(spec: SceneSpec) -> str:
    return (f"a {spec.size} {spec.color} {spec.shape} at the {spec.position} "
            f"on a {spec.background} background")


_CAP_RE = re.compile(
    rf"(?P<size>{'|'.join(SIZES)})?\s*(?P<color>{'|'.join(COLORS)})?\s*"
    rf"(?P<shape>{'|'.join(SHAPES)})")


def parse_caption(text: str) -> SceneSpec:
    """Best-effort inverse of ``caption_of`` (robust to reordered phrases —
    the prompt optimizer permutes phrase order)."""
    t = text.lower()

    def find(options, default):
        for o in options:
            if re.search(rf"\b{o}\b", t):
                return o
        return default

    shape = find(SHAPES, "circle")
    size = find(SIZES, "medium")
    position = find(POSITIONS, "center")
    background = "black"
    m = re.search(rf"on an? (\w+) background", t)
    if m and m.group(1) in BACKGROUNDS:
        background = m.group(1)
    else:
        # phrase reordering (prompt optimizer) may strip the "on";
        # background words are disjoint from color words, so a bare
        # mention is unambiguous
        background = find(BACKGROUNDS, "black")
    # color: first color word that is not the background
    color = "red"
    for c in COLORS:
        if re.search(rf"\b{c}\b", t):
            color = c
            break
    return SceneSpec(shape, color, background, size, position)


def render_scene(spec: SceneSpec, res: int = 32) -> np.ndarray:
    """Render to (res, res, 3) float32 in [-1, 1]."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, res), np.linspace(-1, 1, res),
                         indexing="ij")
    cx, cy = POSITIONS[spec.position]
    r = SIZES[spec.size]
    dx, dy = xx - cx, yy - cy
    if spec.shape == "circle":
        mask = dx * dx + dy * dy <= r * r
    elif spec.shape == "ring":
        d2 = dx * dx + dy * dy
        mask = (d2 <= r * r) & (d2 >= (0.55 * r) ** 2)
    elif spec.shape == "square":
        mask = (np.abs(dx) <= r) & (np.abs(dy) <= r)
    elif spec.shape == "triangle":
        mask = (dy >= -r) & (np.abs(dx) <= (r - dy) * 0.5) & (dy <= r)
    elif spec.shape == "cross":
        mask = ((np.abs(dx) <= 0.3 * r) & (np.abs(dy) <= r)) | \
               ((np.abs(dy) <= 0.3 * r) & (np.abs(dx) <= r))
    else:  # pragma: no cover
        raise ValueError(spec.shape)
    img = np.empty((res, res, 3), np.float32)
    img[:] = np.asarray(BACKGROUNDS[spec.background], np.float32)
    img[mask] = np.asarray(COLORS[spec.color], np.float32)
    return img


def render_caption(caption: str, res: int = 32) -> np.ndarray:
    """Canonical render of a caption (the proxy embedder's text path)."""
    return render_scene(parse_caption(caption), res)


def make_corpus(n: int, *, res: int = 32, seed: int = 0,
                specs: Optional[Sequence[SceneSpec]] = None,
                ) -> Tuple[np.ndarray, List[str], List[SceneSpec]]:
    """Corpus of (images, captions, specs). Deterministic in (n, res, seed)."""
    rng = np.random.default_rng(seed)
    if specs is None:
        specs = [random_spec(rng) for _ in range(n)]
    images = np.stack([render_scene(s, res) for s in specs])
    # mild per-image noise so corpus images are not pixel-identical to renders
    images = images + rng.normal(0, 0.02, images.shape).astype(np.float32)
    images = np.clip(images, -1, 1)
    captions = [caption_of(s) for s in specs]
    return images.astype(np.float32), captions, list(specs)


def all_specs() -> List[SceneSpec]:
    out = []
    for sh in SHAPES:
        for c in COLORS:
            for b in BACKGROUNDS:
                for sz in SIZES:
                    for p in POSITIONS:
                        out.append(SceneSpec(sh, c, b, sz, p))
    return out
