"""BERT masked-LM (bert-base-uncased shape) in PyTorch, for prompt debiasing.

Counterpart of ``dreammat_tpu/models/diffusion/bert.py``: a post-LN
encoder (residual, then LayerNorm), learned token, position and segment
embeddings (segment 0 throughout), and the MLM head (dense, exact gelu,
LayerNorm, then a decoder to the vocabulary with its own bias). The module
and parameter names are the Hugging Face ``BertForMaskedLM`` keys
(``bert.embeddings.word_embeddings.weight``, ``bert.encoder.layer.{i}.
attention.self.query.weight``, ``cls.predictions.decoder.weight``,
``cls.predictions.bias``, ...), so a torch state dict of
``bert-base-uncased`` loads directly through
``convert.load_diffusers_weights``. Attention is plain torch ops with the
padding bias (-1e9 where the mask is 0), as the JAX package's
``jax.nn.dot_product_attention`` with a bias: the attention kernel of the
port has no padding mask, and BERT runs a handful of 32-token sequences
once per run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 512
    type_vocab_size: int = 2

    @staticmethod
    def base_uncased() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                          num_layers=2, num_heads=2, max_length=32)


def _layer_norm(c: BertConfig) -> nn.LayerNorm:
    return nn.LayerNorm(c.hidden_size, eps=1e-12)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_length, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = _layer_norm(c)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        N = input_ids.shape[1]
        x = (self.word_embeddings(input_ids) + self.position_embeddings.weight[None, :N]
             + self.token_type_embeddings.weight[0][None, None])
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.num_heads = c.num_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        split = lambda t: t.reshape(B, N, H, C // H).transpose(1, 2)  # [B,H,N,d]
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = q @ k.transpose(-1, -2) / math.sqrt(C // H) + bias
        return (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, N, C)


class BertSelfOutput(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)
        self.LayerNorm = _layer_norm(c)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(c)
        self.output = BertSelfOutput(c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output.LayerNorm(x + self.output.dense(self.self(x, bias)))


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.intermediate_size, c.hidden_size)
        self.LayerNorm = _layer_norm(c)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertOutput(c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(c) for _ in range(c.num_layers)])


class BertModel(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoder(c)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)
        self.LayerNorm = _layer_norm(c)


class BertLMPredictionHead(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(c)
        self.decoder = nn.Linear(c.hidden_size, c.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size))


class BertOnlyMLMHead(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(c)


class BertForMaskedLM(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.cls = BertOnlyMLMHead(cfg)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """input_ids and attn_mask [B,N] (1 = attend) -> MLM logits [B,N,vocab]."""
        bias = torch.where(attn_mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
        x = self.bert.embeddings(input_ids)
        for layer in self.bert.encoder.layer:
            x = layer(x, bias)
        p = self.cls.predictions
        h = p.transform.LayerNorm(F.gelu(p.transform.dense(x)))
        return (p.decoder(h) + p.bias).float()
