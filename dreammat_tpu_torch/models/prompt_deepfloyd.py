"""DeepFloyd IF prompt processor: T5 text embeddings; and the dummy processor.

Counterpart of ``dreammat_tpu/models/prompt_deepfloyd.py``: the
view-dependent prompts, the embedding cache and the Perp-Neg embeddings of
``StableDiffusionPromptProcessor`` with the T5-v1.1 encoder in place of
CLIP (``diffusion/t5.py``: XXL for ``model_size: sd21``, 4.8 B parameters,
tiny otherwise), random-initialized in fp32, then loaded from
``pretrained_model_cache_dir/text_encoder`` where that holds a checkpoint.
The encoder runs once, when the embeddings are made, and is dropped after
(the XXL tower holds 19 GB in fp32).

Tokens: with ``tokenizer/spiece.model`` in the cache directory and the
``transformers`` package installed, its ``T5Tokenizer``; otherwise the
byte-level stand-in of the JAX package (pad 0, eos 1, byte b -> 2 + b),
which is not SentencePiece: real weights need the real tokenizer files.

``dummy-prompt-processor`` is the processor of the prompt-free guidances:
the tiny CLIP's embeddings of the (empty) prompt, no cache.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.convert import build_on, load_model_dir, random_init_
from dreammat_tpu_torch.models.diffusion.t5 import T5Config, T5Encoder
from dreammat_tpu_torch.models.prompt import PromptEmbeddings, StableDiffusionPromptProcessor


class T5ByteFallbackTokenizer:
    """Byte-level stand-in for SentencePiece: pad 0, eos 1, byte b -> 2 + b."""

    def __init__(self, max_length: int, vocab_size: int):
        self.max_length = max_length
        self.vocab_size = vocab_size

    def batch(self, prompts: List[str]) -> np.ndarray:
        out = np.zeros((len(prompts), self.max_length), np.int32)
        for i, p in enumerate(prompts):
            ids = [2 + b for b in p.encode("utf-8")][: self.max_length - 1]
            ids.append(1)  # </s>
            out[i, : len(ids)] = np.asarray(ids) % self.vocab_size
        return out


class T5SentencePieceTokenizer:
    """T5 tokenization through ``transformers`` (needs ``spiece.model``)."""

    def __init__(self, tok, max_length: int):
        self.tok = tok
        self.max_length = max_length

    def batch(self, prompts: List[str]) -> np.ndarray:
        enc = self.tok(list(prompts), padding="max_length", max_length=self.max_length,
                       truncation=True, return_tensors="np")
        return enc["input_ids"].astype(np.int32)


def t5_tokenizer(cache_dir: str, tcfg: T5Config):
    tok_dir = os.path.join(cache_dir, "tokenizer")
    if os.path.exists(os.path.join(tok_dir, "spiece.model")):
        try:
            from transformers import T5Tokenizer

            dreammat_tpu_torch.info("T5 tokenizer from %s", tok_dir)
            return T5SentencePieceTokenizer(T5Tokenizer.from_pretrained(tok_dir), tcfg.max_length)
        except Exception as e:  # transformers absent or the files unreadable
            dreammat_tpu_torch.warn("T5 tokenizer not loaded (%s): byte-level stand-in", e)
    return T5ByteFallbackTokenizer(tcfg.max_length, tcfg.vocab_size)


@dreammat_tpu_torch.register("deep-floyd-prompt-processor")
class DeepFloydPromptProcessor(StableDiffusionPromptProcessor):
    @dataclass
    class Config(StableDiffusionPromptProcessor.Config):
        pretrained_model_name_or_path: str = "DeepFloyd/IF-I-XL-v1.0"

    cfg: Config

    def get_encoder(self, generator: Optional[torch.Generator] = None):
        """(T5 encoder, tokenizer); the encoder random-initialized on first
        use, then loaded from ``pretrained_model_cache_dir/text_encoder``."""
        tcfg = T5Config.xxl() if self.cfg.model_size == "sd21" else T5Config.tiny()
        if self.text_encoder is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            model = build_on(lambda: T5Encoder(tcfg), self.device, torch.float32)
            model = random_init_(model, generator).eval().requires_grad_(False)
            self.loaded = load_model_dir(
                model, os.path.join(self.cfg.pretrained_model_cache_dir, "text_encoder"), "t5")
            self.text_encoder = model
        return self.text_encoder, t5_tokenizer(self.cfg.pretrained_model_cache_dir, tcfg)

    def __call__(self) -> PromptEmbeddings:
        emb = super().__call__()
        self.text_encoder = None  # the embeddings are made; free the tower
        return emb


@dreammat_tpu_torch.register("dummy-prompt-processor")
class DummyPromptProcessor(StableDiffusionPromptProcessor):
    """Tiny-CLIP embeddings of the (empty) prompt, for prompt-free guidances."""

    @dataclass
    class Config(StableDiffusionPromptProcessor.Config):
        prompt: str = ""
        model_size: str = "tiny"
        use_cache: bool = False
