"""CLIP text encoder (OpenCLIP ViT-H text tower, as in SD 2.1) in PyTorch.

Counterpart of ``dreammat_tpu/models/diffusion/clip_text.py``: token +
position embeddings, pre-LN causal transformer, final LayerNorm, with
``transformers.CLIPTextModel`` key names. The causal attention is plain
matmul + masked softmax (kernel A is non-causal).

``CLIPTextConfig.ip2p()`` is the text tower InstructPix2Pix ships
(``timbrooks/instruct-pix2pix``, SD 1.5's OpenAI CLIP ViT-L/14: 768 wide,
12 layers, quick-GELU MLPs), the width of the IP2P UNet's cross-attention.
The JAX package has no such config: its prompt processor gives SD 2.1's
1024-wide embeddings to the 768-wide IP2P UNet (ROADMAP, queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 23
    num_heads: int = 16
    max_length: int = 77
    hidden_act: str = "gelu"  # "gelu" | "quick_gelu"

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def ip2p() -> "CLIPTextConfig":
        return CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_layers=12,
                              num_heads=12, hidden_act="quick_gelu")

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1024, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_length=16,
        )


class _SelfAttn(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.num_heads = c.num_heads
        self.q_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.k_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.v_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.out_proj = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        q = self.q_proj(x).reshape(B, N, self.num_heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, N, self.num_heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, N, self.num_heads, hd).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(N, N, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        out = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class _MLP(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)
        self.quick = c.hidden_act == "quick_gelu"

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h) if self.quick else F.gelu(h))


class _Layer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=1e-5)
        self.self_attn = _SelfAttn(c)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=1e-5)
        self.mlp = _MLP(c)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_length, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(c) for _ in range(c.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B,N] -> last_hidden_state [B,N,hidden]."""
        tm = self.text_model
        N = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:N][None]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)
