"""WordPiece tokenizer (BERT-style) in pure Python, for prompt debiasing.

The port's own copy of ``dreammat_tpu/models/diffusion/wordpiece.py``
(pure Python, copied so that the port imports nothing of the JAX
package). It reads ``<model_dir>/vocab.txt`` when one exists; otherwise it
falls back to a deterministic word-hash vocabulary, which keeps the
debiasing runnable without files (the PMI rule only needs stable ids;
meaningful debiasing needs real BERT weights and vocabulary).

BERT-base special ids: [PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103.
"""

from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, List, Optional

PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = 0, 100, 101, 102, 103


def _basic_tokenize(text: str) -> List[str]:
    """Lowercase, strip accents, split on whitespace and punctuation."""
    text = unicodedata.normalize("NFD", text.lower())
    out, cur = [], []
    for ch in text:
        if unicodedata.category(ch) == "Mn":
            continue
        if ch.isspace():
            if cur:
                out.append("".join(cur))
                cur = []
        elif not (ch.isalnum() or ch == "'"):
            if cur:
                out.append("".join(cur))
                cur = []
            if not ch.isspace():
                out.append(ch)
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [t for t in out if t.strip()]


class WordPieceTokenizer:
    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 vocab_size: int = 30522, mask_token: str = "[MASK]"):
        self.vocab = vocab
        self.vocab_size = vocab_size
        self.mask_token = mask_token
        self.mask_token_id = (vocab or {}).get(mask_token, MASK_ID)

    @classmethod
    def from_dir(cls, model_dir: Optional[str], vocab_size: int = 30522):
        """Load <dir>/vocab.txt when present, else the hash fallback."""
        if model_dir:
            p = os.path.join(model_dir, "vocab.txt")
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
                return cls(vocab=vocab, vocab_size=len(vocab))
        return cls(vocab=None, vocab_size=vocab_size)

    def _hash_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        lo = min(999, max(self.vocab_size // 4, MASK_ID + 1))
        return lo + h % (self.vocab_size - lo)

    def _wordpiece(self, word: str) -> List[int]:
        if self.vocab is None:
            return [self._hash_id(word)]  # whole-word fallback
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.vocab.get("[UNK]", UNK_ID)]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 32):
        """-> (input_ids, attn_mask) python int lists, padded to max_length,
        with [CLS] ... [SEP]. The literal mask token maps to [MASK]."""
        ids: List[int] = [CLS_ID if self.vocab is None else self.vocab.get("[CLS]", CLS_ID)]
        for piece in text.replace(self.mask_token, f" {self.mask_token} ").split():
            if piece == self.mask_token:
                ids.append(self.mask_token_id)
                continue
            for w in _basic_tokenize(piece):
                ids.extend(self._wordpiece(w))
        ids.append(SEP_ID if self.vocab is None else self.vocab.get("[SEP]", SEP_ID))
        ids = ids[:max_length]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        ids = ids + [PAD_ID] * (max_length - len(ids))
        return ids, mask

    def tokenize_words(self, words: List[str]) -> List[int]:
        """First wordpiece id per word (the reference takes input_ids[1:5]
        of the space-joined view names — each is a single BERT token)."""
        out = []
        for w in words:
            out.append(self._wordpiece(_basic_tokenize(w)[0])[0])
        return out
