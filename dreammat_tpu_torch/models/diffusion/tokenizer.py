"""CLIP BPE tokenizer (self-contained).

Equivalent of the ``CLIPTokenizer`` the reference pulls from HuggingFace
(threestudio_dreammat/threestudio/models/prompt_processors/
stable_diffusion_prompt_processor.py:74-90). Loads ``vocab.json`` +
``merges.txt`` from a local SD checkpoint directory when available (they ship
with every SD checkpoint); without them it falls back to a deterministic
hash vocabulary so the full pipeline still runs hermetically (the text
encoder is randomly initialized in that case anyway).
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
) if hasattr(re, "Pattern") and False else re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
    re.IGNORECASE,
)


def basic_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text.strip()).lower()


class CLIPTokenizer:
    BOS = 49406
    EOS = 49407

    def __init__(self, vocab_dir: Optional[str] = None, max_length: int = 77, vocab_size: int = 49408):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.byte_encoder = bytes_to_unicode()
        self.encoder: Optional[Dict[str, int]] = None
        self.bpe_ranks: Dict[Tuple[str, str], int] = {}
        self.cache: Dict[str, str] = {}
        if vocab_dir:
            vj = os.path.join(vocab_dir, "vocab.json")
            mt = os.path.join(vocab_dir, "merges.txt")
            if os.path.exists(vj) and os.path.exists(mt):
                with open(vj, encoding="utf-8") as f:
                    self.encoder = json.load(f)
                with open(mt, encoding="utf-8") as f:
                    merges = f.read().split("\n")
                merges = [m for m in merges if m and not m.startswith("#")]
                self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
                self.vocab_size = max(self.encoder.values()) + 1

    @property
    def has_real_vocab(self) -> bool:
        return self.encoder is not None

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _encode_word(self, token: str) -> List[int]:
        if self.encoder is not None:
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            return [
                self.encoder.get(t, self.encoder.get("<|endoftext|>", self.EOS))
                for t in self.bpe(token_b).split(" ")
            ]
        # deterministic hash fallback (no vocab assets in the image)
        h = 0
        for ch in token:
            h = (h * 131 + ord(ch)) % (self.vocab_size - 3)
        return [h + 1]

    def __call__(self, text: str) -> np.ndarray:
        """Tokenize to fixed-length [max_length] int32 with BOS/EOS+pad
        (CLIP pads with EOS)."""
        text = basic_clean(text)
        ids: List[int] = [self.BOS if self.encoder else 1 % self.vocab_size]
        bos = self.BOS if self.encoder else min(self.vocab_size - 2, self.BOS)
        eos = self.EOS if self.encoder else min(self.vocab_size - 1, self.EOS)
        ids = [bos]
        for tok in _PAT.findall(text):
            ids.extend(self._encode_word(tok))
            if len(ids) >= self.max_length - 1:
                break
        ids = ids[: self.max_length - 1]
        ids.append(eos)
        while len(ids) < self.max_length:
            ids.append(eos)
        return np.asarray(ids, dtype=np.int32)

    def batch(self, texts: List[str]) -> np.ndarray:
        return np.stack([self(t) for t in texts])
