"""T5-v1.1 text encoder (encoder-only stack, DeepFloyd IF's text tower) in PyTorch.

Counterpart of ``dreammat_tpu/models/diffusion/t5.py``: RMSNorm (no bias,
no mean subtraction, computed in fp32), pre-norm residual blocks,
self-attention without the 1/sqrt(d) scale plus a relative position bias
(32 bidirectional buckets, max distance 128) held by the first block and
shared by all, a gated-GELU feed-forward (tanh GELU of ``wi_0`` times
``wi_1``, then ``wo``), no absolute position embedding, a final RMSNorm.
Key names are ``transformers.T5EncoderModel``'s.

The attention adds the position bias to its scores, so it is plain matmul
and softmax (kernel A takes no bias); the JAX package has no Pallas kernel
here either, and the encoder runs once per prompt set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    max_length: int = 77

    @staticmethod
    def xxl() -> "T5Config":
        """T5-v1.1-XXL encoder, the DeepFloyd IF text tower."""
        return T5Config()

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                        num_heads=4, max_length=16)


def relative_position_bucket(rel: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucketing of relative offsets (HF
    ``_relative_position_bucket``)."""
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    n = np.abs(rel)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (np.log(np.maximum(n, 1) / max_exact)
                             / np.log(max_distance / max_exact)
                             * (num_buckets - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5LayerNorm(nn.Module):
    """RMSNorm: x / sqrt(mean(x^2) + eps) * weight, the moment in fp32."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class _SelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.c = c
        self.q = nn.Linear(c.d_model, inner, bias=False)
        self.k = nn.Linear(c.d_model, inner, bias=False)
        self.v = nn.Linear(c.d_model, inner, bias=False)
        self.o = nn.Linear(inner, c.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(c.relative_attention_num_buckets,
                                                        c.num_heads)

    def forward(self, x, position_bias):
        c = self.c
        B, N, _ = x.shape
        split = lambda t: t.reshape(B, N, c.num_heads, c.d_kv).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() + position_bias
        out = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
        return self.o(out.transpose(1, 2).reshape(B, N, -1))


class _LayerSelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(c, has_bias)
        self.layer_norm = T5LayerNorm(c.d_model)


class _DenseGatedGelu(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wi_1 = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class _LayerFF(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(c)
        self.layer_norm = T5LayerNorm(c.d_model)


class _Block(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_LayerSelfAttention(c, has_bias), _LayerFF(c)])

    def forward(self, x, position_bias):
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_Block(c, i == 0) for i in range(c.num_layers)])
        self.final_layer_norm = T5LayerNorm(c.d_model)


class T5Encoder(nn.Module):
    """input_ids [B,N] -> last_hidden_state [B,N,d_model] (fp32)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def position_bias(self, n: int) -> torch.Tensor:
        """[1, heads, n, n] fp32: the shared bias table at each offset's bucket."""
        c = self.cfg
        pos = np.arange(n)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           c.relative_attention_num_buckets,
                                           c.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        idx = torch.as_tensor(buckets, device=table.device)
        return table[idx].permute(2, 0, 1)[None].float()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids)
        bias = self.position_bias(input_ids.shape[1])
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x).float()
