"""Generation-strategy policy (paper §IV-F, Algorithm 1, Fig. 7).

Composite similarity score  S = CLIPScore + PickScore  (Eq. 7), then:

    S  > hi  (0.5)        -> HIT_RETURN  : ship the cached image, 0 steps
    lo <= S <= hi (0.4..) -> IMG2IMG     : SDEdit from noised reference, K steps
    S  < lo  (0.4)        -> TXT2IMG     : full generation from noise, N steps

Both scores are normalised to [0, 1] before summing and the sum is halved,
so thresholds live on the paper's 0..1 scale. Thresholds are configurable —
benchmark fig15 sweeps them exactly like the paper's Figure 15.

Latent-depth schedule (beyond-paper, NIRVANA-style): when
``latent_depths`` is set, the binary img2img band refines into a DEPTH
schedule — the [lo, hi] band splits into ``len(latent_depths) + 1`` equal
sub-bands mapping match quality to a resume depth ``k`` (how many of the
K img2img chain steps an archived noised latent already absorbs): a weak
match resumes shallow (k = 0, the classic full img2img), a strong match
resumes deep and only runs ``K - k`` steps.  ``resume_depth`` is the
single home of that mapping.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np


class Route(enum.Enum):
    HIT_RETURN = "hit_return"
    IMG2IMG = "img2img"
    TXT2IMG = "txt2img"


@dataclass
class GenerationPolicy:
    lo: float = 0.4
    hi: float = 0.5
    steps_full: int = 30   # N — text-to-image denoising steps
    steps_ref: int = 20    # K — image-to-image denoising steps (K < N)
    # resume depths of the latent-depth cache, ascending; () disables the
    # depth schedule (classic binary img2img/txt2img split)
    latent_depths: Tuple[int, ...] = ()

    def composite_score(self, clip_score: float, pick_score: float) -> float:
        """Eq. 7 with both terms mapped to [0,1]; mean keeps S in [0,1]."""
        return 0.5 * (float(clip_score) + float(pick_score))

    def composite_scores(self, clip_scores: np.ndarray,
                         pick_scores: np.ndarray) -> np.ndarray:
        """Vectorised Eq. 7 over a candidate set — the serve pipeline's
        Score stage pairs this with ``Embedder.score_candidates`` so no
        per-candidate Python call survives on the hot path."""
        return 0.5 * (np.asarray(clip_scores, np.float64)
                      + np.asarray(pick_scores, np.float64))

    def route(self, score: float) -> Route:
        if score > self.hi:
            return Route.HIT_RETURN
        if score >= self.lo:
            return Route.IMG2IMG
        return Route.TXT2IMG

    def steps_for(self, route: Route) -> int:
        return {Route.HIT_RETURN: 0, Route.IMG2IMG: self.steps_ref,
                Route.TXT2IMG: self.steps_full}[route]

    # -- latent-depth schedule (beyond-paper) -------------------------------

    def default_latent_depths(self) -> Tuple[int, ...]:
        """The archive depths k ∈ {K/4, K/2, 3K/4} of the latent-depth
        cache (K = ``steps_ref``), deduped and 0-free for tiny K."""
        k = self.steps_ref
        return tuple(sorted({k // 4, k // 2, (3 * k) // 4} - {0}))

    def resume_depth(self, score: float) -> int:
        """Map a composite score in the img2img band to a resume depth.

        The [lo, hi] band splits into ``len(latent_depths) + 1`` equal
        sub-bands over the depth levels ``(0,) + latent_depths``
        (ascending): score = lo resumes at depth 0 (full img2img), score
        >= hi resumes at the deepest archived level.  Sub-band boundaries
        belong to the DEEPER band (``frac·len(levels)`` floors, so an
        exact edge rounds up in depth).  With ``latent_depths == ()``
        every band score maps to depth 0 — the classic binary split."""
        if not self.latent_depths:
            return 0
        levels = (0,) + tuple(sorted(self.latent_depths))
        frac = (float(score) - self.lo) / max(self.hi - self.lo, 1e-12)
        frac = min(max(frac, 0.0), 1.0)
        return levels[min(int(frac * len(levels)), len(levels) - 1)]

    def steps_for_resume(self, k: int) -> int:
        """Denoising steps still to run when resuming from depth ``k``."""
        return max(self.steps_ref - int(k), 0)


def select_reference(scores: np.ndarray) -> int:
    """argmax over the unioned candidate set (Algorithm 1 line 8)."""
    if scores.size == 0:
        return -1
    return int(np.argmax(scores))


def make_score_fn(embedder) -> Callable:
    """Build S_sim(P, I) from an embedding generator: CLIPScore uses the
    text/image cosine; PickScore uses the embedder's preference proxy."""

    def score(prompt_vec: np.ndarray, img_vec: np.ndarray, image=None) -> float:
        clip_s = float(np.clip((prompt_vec @ img_vec + 1.0) / 2.0, 0.0, 1.0))
        pick_s = float(embedder.pick_score(prompt_vec, img_vec, image))
        return clip_s, pick_s

    return score
