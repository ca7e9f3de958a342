"""AutoencoderKL (SD VAE) in PyTorch, NCHW.

Counterpart of ``dreammat_tpu/models/diffusion/vae.py``. The train step
needs only ``encode``; the decoder is built too so that the whole VAE state
dict (encoder and decoder) loads strictly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreammat_tpu_torch.models.diffusion import layers as L


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 64), layers_per_block=1)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([L.ResnetBlock(ch, ch, None), L.ResnetBlock(ch, ch, None)])
        self.attentions = nn.ModuleList([L.SelfAttention2D(ch)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _Down(nn.Module):
    def __init__(self, in_ch: int, ch: int, n: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [L.ResnetBlock(in_ch if i == 0 else ch, ch, None) for i in range(n)])
        if downsample:
            self.downsamplers = nn.ModuleList([L.Downsample(ch, ch)])

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if hasattr(self, "downsamplers"):
            h = self.downsamplers[0](h)
        return h


class _Up(nn.Module):
    def __init__(self, in_ch: int, ch: int, n: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [L.ResnetBlock(in_ch if i == 0 else ch, ch, None) for i in range(n)])
        if upsample:
            self.upsamplers = nn.ModuleList([L.Upsample(ch, ch)])

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0](h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        downs, prev = [], chs[0]
        for b, ch in enumerate(chs):
            downs.append(_Down(prev, ch, cfg.layers_per_block, b != len(chs) - 1))
            prev = ch
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = _Mid(chs[-1])
        self.conv_norm_out = nn.GroupNorm(32, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0])
        ups, prev = [], rev[0]
        for b, ch in enumerate(rev):
            ups.append(_Up(prev, ch, cfg.layers_per_block + 1, b != len(rev) - 1))
            prev = ch
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode_moments(self, x):
        """x in [-1,1], NCHW -> (mean, logvar) of the latent posterior."""
        h = self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))
        mean, logvar = h.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, eps: Optional[torch.Tensor] = None):
        """Scaled latent: the posterior mean, plus ``exp(logvar/2) * eps``
        when a standard-normal draw ``eps`` is given."""
        mean, logvar = self.encode_moments(x)
        if eps is not None:
            mean = mean.float() + torch.exp(0.5 * logvar.float()) * eps.float()
        return mean * self.cfg.scaling_factor

    def decode(self, z):
        z = z / self.cfg.scaling_factor
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))
