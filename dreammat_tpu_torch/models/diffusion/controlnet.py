"""ControlNet (22-channel geometry- and light-aware conditioning), NCHW.

Counterpart of ``dreammat_tpu/models/diffusion/controlnet.py``: a copy of
the UNet's down and mid path, a conditioning-embedding stem that brings the
image-resolution condition stack to latent resolution, and 1x1 output convs
producing additive residuals scaled by ``conditioning_scale``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreammat_tpu_torch.models.diffusion import layers as L
from dreammat_tpu_torch.models.diffusion.unet import (
    CrossAttnDownBlock, MidBlock, UNetConfig, down_path_channels,
)


@dataclass(frozen=True)
class ControlNetConfig:
    unet: UNetConfig = field(default_factory=UNetConfig)
    conditioning_channels: int = 22
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)


class ConditioningEmbedding(nn.Module):
    def __init__(self, in_channels: int, channels: Tuple[int, ...], out_channels: int):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels[0], 3, padding=1)
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(nn.Conv2d(channels[i], channels[i], 3, padding=1))
            blocks.append(nn.Conv2d(channels[i], channels[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for blk in self.blocks:
            h = F.silu(blk(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """Returns (down residuals, mid residual), already scaled. The condition
    may be batch 1 while the sample is batch B (the CFG replicas share one
    condition stack): the stem then runs once and broadcasts."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        self.cfg = cfg
        ucfg = cfg.unet
        ch0 = ucfg.block_out_channels[0]
        temb_ch = ch0 * 4
        self.time_embedding = L.TimestepEmbedding(ch0, temb_ch)
        self.conv_in = nn.Conv2d(ucfg.in_channels, ch0, 3, padding=1)
        self.controlnet_cond_embedding = ConditioningEmbedding(
            cfg.conditioning_channels, cfg.conditioning_embedding_channels, ch0)
        nb = len(ucfg.block_out_channels)
        downs, prev = [], ch0
        for b, out_ch in enumerate(ucfg.block_out_channels):
            downs.append(CrossAttnDownBlock(
                ucfg, prev, out_ch, ucfg.down_block_has_attn[b], b != nb - 1, temb_ch))
            prev = out_ch
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = MidBlock(ucfg, ucfg.block_out_channels[-1], temb_ch)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in down_path_channels(ucfg)]
        )
        last = ucfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(last, last, 1)

    def forward(self, sample, timesteps, context, controlnet_cond, conditioning_scale=1.0):
        ucfg = self.cfg.unet
        dtype = self.conv_in.weight.dtype
        temb = L.timestep_embedding(
            timesteps, ucfg.block_out_channels[0], flip_sin_to_cos=ucfg.flip_sin_to_cos,
            downscale_freq_shift=ucfg.freq_shift,
        )
        temb = self.time_embedding(temb.to(dtype))
        context = context.to(dtype)
        x = self.conv_in(sample.to(dtype))
        x = x + self.controlnet_cond_embedding(controlnet_cond.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            x, outs = blk(x, temb, context)
            skips.extend(outs)
        x = self.mid_block(x, temb, context)
        down = [conv(s) * conditioning_scale for conv, s in zip(self.controlnet_down_blocks, skips)]
        return down, self.controlnet_mid_block(x) * conditioning_scale
