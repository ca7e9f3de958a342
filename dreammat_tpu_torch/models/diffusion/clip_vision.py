"""CLIP vision tower (the image embedder Zero123 conditions on) in PyTorch.

Counterpart of ``dreammat_tpu/models/diffusion/clip_vision.py``: CLIP's
per-channel normalization, a linear resize to ``image_size`` (antialiased
when it shrinks, as ``jax.image.resize`` is), the patch convolution without
bias, the class token and the position embedding, a pre-LN, pre-LN
transformer blocks with exact GELU, a post-LN and the class token's
``visual_projection``: [B,3,S,S] in [0,1] -> [B,1,projection_dim], with
``transformers.CLIPVisionModelWithProjection`` key names (HF's literal
``pre_layrnorm`` included). The LayerNorms compute in fp32, as the JAX
package's do.

The attention is plain matmul and softmax, as the JAX package's
``jax.nn.dot_product_attention`` is no Pallas kernel: the tower runs once,
when the guidance embeds its conditioning image, and its 257 tokens of
head dim 64 are no part of a training step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768

    @staticmethod
    def vit_l14() -> "CLIPVisionConfig":
        """ViT-L/14, the tower Zero123's image conditioning uses."""
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64,
                                intermediate_size=128, num_layers=2, num_heads=4,
                                projection_dim=64)


def layer_norm32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln`` computed in fp32 (its parameters may be stored in bf16)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps)


class _SelfAttn(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.num_heads = c.num_heads
        self.q_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.k_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.v_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.out_proj = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        split = lambda t: t.reshape(B, N, self.num_heads, hd).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd), dim=-1)
        out = torch.matmul(p.to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class _MLP(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Layer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=1e-5)
        self.self_attn = _SelfAttn(c)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=1e-5)
        self.mlp = _MLP(c)

    def forward(self, x):
        dt = self.mlp.fc1.weight.dtype
        x = x + self.self_attn(layer_norm32(self.layer_norm1, x).to(dt)).float()
        return x + self.mlp(layer_norm32(self.layer_norm2, x).to(dt)).float()


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        n = (c.image_size // c.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(n + 1, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(c) for _ in range(c.num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=1e-5)
        self.encoder = _Encoder(c)
        self.post_layernorm = nn.LayerNorm(c.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """[B,3,S,S] image in [0,1] -> [B,1,projection_dim] embedding (fp32)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c, vm = self.cfg, self.vision_model
        emb = vm.embeddings
        dt = emb.patch_embedding.weight.dtype
        mean = torch.tensor(CLIP_MEAN, device=images.device).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=images.device).reshape(1, 3, 1, 1)
        x = (images.float() - mean) / std
        if x.shape[-1] != c.image_size:
            x = F.interpolate(x, size=(c.image_size, c.image_size), mode="bilinear",
                              align_corners=False, antialias=True)
        x = emb.patch_embedding(x.to(dt)).flatten(2).transpose(1, 2)  # [B,n,hidden]
        cls = emb.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(dt)[None]
        x = layer_norm32(vm.pre_layrnorm, x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = layer_norm32(vm.post_layernorm, x)[:, 0]
        return self.visual_projection(pooled.to(dt))[:, None, :].float()
