"""UNet2DCondition (SD 2.1-base layout) in PyTorch, NCHW.

Counterpart of ``dreammat_tpu/models/diffusion/unet.py``, with the same
config (``UNetConfig.sd21()`` / ``.tiny()``) and the ControlNet injection
points ``down_block_additional_residuals`` / ``mid_block_additional_residual``.
``class_embed_dim`` adds diffusers' ``class_embedding`` slot, a
``TimestepEmbedding(class_embed_dim -> 4 ch0)`` of ``class_labels`` added to
the time embedding (the VSD guidance feeds it the flattened camera); without
it the module's keys are those of a plain SD2.1 UNet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreammat_tpu_torch.models.diffusion import layers as L


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    attention_head_dim: int = 64
    cross_attention_dim: int = 1024
    transformer_depth: int = 1
    use_linear_projection: bool = True
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @staticmethod
    def sd21() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(32, 64),
            down_block_has_attn=(True, False),
            attention_head_dim=8,
            cross_attention_dim=64,
            layers_per_block=1,
        )


def _transformer(cfg: UNetConfig, channels: int) -> L.Transformer2D:
    return L.Transformer2D(
        channels, channels // cfg.attention_head_dim, cfg.attention_head_dim,
        cfg.transformer_depth, cfg.cross_attention_dim, cfg.use_linear_projection,
    )


class CrossAttnDownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int,
                 has_attn: bool, add_downsample: bool, temb_channels: int):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([
            L.ResnetBlock(in_channels if i == 0 else out_channels, out_channels, temb_channels)
            for i in range(n)
        ])
        if has_attn:
            self.attentions = nn.ModuleList([_transformer(cfg, out_channels) for _ in range(n)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([L.Downsample(out_channels, out_channels)])

    def forward(self, x, temb, context):
        outputs = []
        for i, res in enumerate(self.resnets):
            x = res(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
            outputs.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class CrossAttnUpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, skip_channels: List[int],
                 out_channels: int, has_attn: bool, add_upsample: bool, temb_channels: int):
        super().__init__()
        res = []
        ch = in_channels
        for s in skip_channels:
            res.append(L.ResnetBlock(ch + s, out_channels, temb_channels))
            ch = out_channels
        self.resnets = nn.ModuleList(res)
        if has_attn:
            self.attentions = nn.ModuleList(
                [_transformer(cfg, out_channels) for _ in skip_channels]
            )
        if add_upsample:
            self.upsamplers = nn.ModuleList([L.Upsample(out_channels, out_channels)])

    def forward(self, x, skips: list, temb, context):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, temb_channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            L.ResnetBlock(channels, channels, temb_channels),
            L.ResnetBlock(channels, channels, temb_channels),
        ])
        self.attentions = nn.ModuleList([_transformer(cfg, channels)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


def down_path_channels(cfg: UNetConfig) -> List[int]:
    """Channels of every skip tensor the down path emits, in order."""
    ch = [cfg.block_out_channels[0]]
    for b, out_ch in enumerate(cfg.block_out_channels):
        ch += [out_ch] * cfg.layers_per_block
        if b != len(cfg.block_out_channels) - 1:
            ch.append(out_ch)
    return ch


class UNet2DCondition(nn.Module):
    """sample [B,C,h,w], timesteps [B], context [B,N,cross] -> eps (fp32)."""

    def __init__(self, cfg: UNetConfig, class_embed_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        self.time_embedding = L.TimestepEmbedding(ch0, temb_ch)
        if class_embed_dim is not None:
            self.class_embedding = L.TimestepEmbedding(class_embed_dim, temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        nb = len(cfg.block_out_channels)
        downs, prev = [], ch0
        for b, out_ch in enumerate(cfg.block_out_channels):
            downs.append(CrossAttnDownBlock(
                cfg, prev, out_ch, cfg.down_block_has_attn[b], b != nb - 1, temb_ch))
            prev = out_ch
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = MidBlock(cfg, cfg.block_out_channels[-1], temb_ch)
        skips = down_path_channels(cfg)
        ups = []
        rev_ch = list(reversed(cfg.block_out_channels))
        rev_attn = list(reversed(cfg.down_block_has_attn))
        for b, out_ch in enumerate(rev_ch):
            mine = [skips.pop() for _ in range(cfg.layers_per_block + 1)]
            ups.append(CrossAttnUpBlock(
                cfg, prev, mine, out_ch, rev_attn[b], b != nb - 1, temb_ch))
            prev = out_ch
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def time_embed(self, timesteps):
        cfg = self.cfg
        temb = L.timestep_embedding(
            timesteps, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift,
        )
        return self.time_embedding(temb.to(self.conv_in.weight.dtype))

    def forward(self, sample, timesteps, context,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None):
        dtype = self.conv_in.weight.dtype
        temb = self.time_embed(timesteps)
        if class_labels is not None:
            temb = temb + self.class_embedding(class_labels.to(dtype))
        context = context.to(dtype)
        x = self.conv_in(sample.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            x, outs = blk(x, temb, context)
            skips.extend(outs)
        x = self.mid_block(x, temb, context)
        if down_block_additional_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_block_additional_residuals)]
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual
        for blk in self.up_blocks:
            x = blk(x, skips, temb, context)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.float()
