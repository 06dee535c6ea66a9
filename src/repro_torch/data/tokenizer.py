"""Hash tokenizer — deterministic, dependency-free word-level tokenizer
(a copy of the JAX package's ``repro/data/tokenizer.py`` over the port's
``utils.stable_hash``).

Words map to ids via a stable FNV hash into a fixed vocab.  Reserved ids:
0 = PAD, 1 = BOS, 2 = EOS.  It feeds the text encoder that
conditions the MMDiT.
"""
from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from repro_torch.utils import stable_hash

_WORD_RE = re.compile(r"[a-zA-Z']+|[0-9]+|[^\sa-zA-Z0-9]")


class HashTokenizer:
    PAD, BOS, EOS = 0, 1, 2
    N_RESERVED = 3

    def __init__(self, vocab_size: int = 32768):
        assert vocab_size > self.N_RESERVED
        self.vocab_size = vocab_size

    def encode(self, text: str, *, max_len: int, add_bos: bool = True,
               add_eos: bool = True) -> np.ndarray:
        words = _WORD_RE.findall(text.lower())
        ids = [self.N_RESERVED + stable_hash(w, self.vocab_size - self.N_RESERVED)
               for w in words]
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        ids = ids[:max_len]
        out = np.full((max_len,), self.PAD, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: Sequence[str], *, max_len: int) -> np.ndarray:
        return np.stack([self.encode(t, max_len=max_len) for t in texts])

    def lengths(self, batch: np.ndarray) -> np.ndarray:
        return (batch != self.PAD).sum(axis=-1)
