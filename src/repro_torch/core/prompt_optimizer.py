"""Prompt optimizer (paper §IV-D).

The paper splits the prompt into phrases with SpaCy dependency parsing,
ranks them with BERT attention mass, and re-emits the phrases in descending
importance (diffusion models weight early tokens more heavily).

Offline adaptation (no SpaCy/BERT): phrases are split on punctuation and
coordinating conjunctions; importance is an attention-mass proxy computed
from (a) content-word rarity (hashed IDF-style weights — rarer = more
specific = more important) and (b) a noun-ish heuristic (head position in
the phrase).  An optional ``attention_fn`` hook lets the trained text tower
supply real attention mass — the integration tests exercise both.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.utils import stable_hash

_STOPWORDS = {
    "a", "an", "the", "of", "on", "in", "at", "with", "and", "or", "to",
    "is", "are", "was", "were", "by", "for", "from", "very", "some",
}
_SPLIT_RE = re.compile(r"[,.;]| and | with | on | in | near ")


def split_phrases(prompt: str) -> List[str]:
    parts = [p.strip() for p in _SPLIT_RE.split(" " + prompt + " ")]
    return [p for p in parts if p]


def _rarity(word: str) -> float:
    """Deterministic IDF proxy: hash-derived rarity in (0, 1]."""
    if word.lower() in _STOPWORDS:
        return 0.05
    return 0.25 + 0.75 * (stable_hash(word.lower(), 10_000) / 10_000.0)


def phrase_importance(phrase: str) -> float:
    words = [w for w in re.findall(r"[a-zA-Z']+", phrase)]
    if not words:
        return 0.0
    scores = [_rarity(w) for w in words]
    # head-word bonus: last content word of a phrase is usually its noun head
    content = [i for i, w in enumerate(words) if w.lower() not in _STOPWORDS]
    if content:
        scores[content[-1]] *= 1.5
    return float(np.mean(scores))


class PromptOptimizer:
    def __init__(self, attention_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None):
        """attention_fn: phrases -> per-phrase attention mass (from the text
        tower); overrides the heuristic when provided."""
        self.attention_fn = attention_fn

    def rank(self, prompt: str) -> List[Tuple[str, float]]:
        phrases = split_phrases(prompt)
        if not phrases:
            return []
        if self.attention_fn is not None:
            w = np.asarray(self.attention_fn(phrases), np.float64)
        else:
            w = np.array([phrase_importance(p) for p in phrases])
        order = np.argsort(-w, kind="stable")
        return [(phrases[i], float(w[i])) for i in order]

    def optimize(self, prompt: str) -> str:
        """Re-emit phrases in descending importance (structured prompt)."""
        ranked = self.rank(prompt)
        if not ranked:
            return prompt
        return ", ".join(p for p, _ in ranked)
