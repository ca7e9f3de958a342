"""GAN building blocks of the Control4D renderer.

Counterpart of ``dreammat_tpu/utils/gan.py``, as ``nn.Module``s on NCHW
tensors (the renderer converts from its NHWC maps):

- ``ResBlock``: GroupNorm, SiLU, 3x3 conv, twice, plus the input (through
  a 1x1 conv where the width changes);
- ``LocalEncoder``: image -> the moments [2 z_channels] of a latent at
  1 / 2^(L-1) of its resolution (L = len(ch_mult));
- ``Generator``: [lr_rgb, z] at low resolution and a global code ->
  RGB at 2^(L-1) times the resolution, the code entering as a FiLM
  (h (1 + scale) + shift) after the first conv, nearest upsampling between
  the resblocks;
- ``GlobalEncoder``: four stride-2 convs, a spatial mean and a linear map
  to the ``n_class``-wide global appearance code;
- ``NLayerDiscriminator``: pix2pix's PatchGAN (4x4 convs, GroupNorm,
  leaky ReLU 0.2);
- the diagonal Gaussian of a moments map (NHWC, channels last: mean, then
  log-variance clamped to [-30, 20]) and its KL to N(0, 1);
- the hinge losses: G = -mean(D(fake)), D = (mean(relu(1 - D(real))) +
  mean(relu(1 + D(fake)))) / 2 on detached images.

GroupNorm's epsilon is flax's 1e-6 and the groups the largest power of two
up to 32 that divides the width, as in the JAX package, whose parameter
trees ``convert.gan_state_dict_from_flax`` carries across.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _groups(c: int) -> int:
    for g in (32, 16, 8, 4, 2):
        if c % g == 0:
            return g
    return 1


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(_groups(c), c, eps=1e-6)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, ch: int):
        super().__init__()
        self.norm1 = _norm(c_in)
        self.conv1 = nn.Conv2d(c_in, ch, 3, padding=1)
        self.norm2 = _norm(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.skip = nn.Conv2d(c_in, ch, 1) if c_in != ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.skip is None else self.skip(x)) + h


class LocalEncoder(nn.Module):
    def __init__(self, ch: int = 32, ch_mult: Sequence[int] = (1, 2, 4), z_channels: int = 4):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        blocks, downs, c = [], [], ch
        for i, m in enumerate(ch_mult):
            blocks.append(ResBlock(c, ch * m))
            c = ch * m
            if i != len(ch_mult) - 1:
                downs.append(nn.Conv2d(c, c, 3, stride=2, padding=1))
        self.blocks, self.downs = nn.ModuleList(blocks), nn.ModuleList(downs)
        self.mid = ResBlock(c, c)
        self.conv_out = nn.Conv2d(c, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i < len(self.downs):
                h = self.downs[i](h)
        return self.conv_out(self.mid(h))


class Generator(nn.Module):
    def __init__(self, in_ch: int, global_dim: int, ch: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4), out_ch: int = 3):
        super().__init__()
        mults = list(reversed(tuple(ch_mult)))
        c = ch * mults[0]
        self.conv_in = nn.Conv2d(in_ch, c, 3, padding=1)
        self.film_scale = nn.Linear(global_dim, c)
        self.film_shift = nn.Linear(global_dim, c)
        blocks, ups = [], []
        for i, m in enumerate(mults):
            blocks.append(ResBlock(c, ch * m))
            c = ch * m
            if i != len(mults) - 1:
                ups.append(nn.Conv2d(c, c, 3, padding=1))
        self.blocks, self.ups = nn.ModuleList(blocks), nn.ModuleList(ups)
        self.norm_out = _norm(c)
        self.conv_out = nn.Conv2d(c, out_ch, 3, padding=1)

    def forward(self, x, g_code):
        h = self.conv_in(x)
        h = h * (1.0 + self.film_scale(g_code)[:, :, None, None]) \
            + self.film_shift(g_code)[:, :, None, None]
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i < len(self.ups):
                h = self.ups[i](F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)))


class GlobalEncoder(nn.Module):
    def __init__(self, n_class: int = 64, ch: int = 32):
        super().__init__()
        chans = [3] + [ch * 2 ** i for i in range(4)]
        self.convs = nn.ModuleList([nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1)
                                    for i in range(4)])
        self.fc = nn.Linear(chans[-1], n_class)

    def forward(self, x):
        h = x
        for conv in self.convs:
            h = F.silu(conv(h))
        return self.fc(h.mean(dim=(2, 3)))


class NLayerDiscriminator(nn.Module):
    def __init__(self, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ndf, 4, stride=2, padding=1)
        convs, norms, c = [], [], ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2 ** n, 8)
            convs.append(nn.Conv2d(c, out, 4, stride=2 if n < n_layers else 1, padding=1,
                                   bias=False))
            norms.append(_norm(out))
            c = out
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.conv_out = nn.Conv2d(c, 1, 4, stride=1, padding=1)

    def forward(self, x):
        h = F.leaky_relu(self.conv_in(x), 0.2)
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(conv(h)), 0.2)
        return self.conv_out(h)


# -- the diagonal Gaussian (NHWC moments) --------------------------------------
def gaussian_moments(latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, logvar = latent.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def gaussian_sample(latent: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """A sample of the moments' Gaussian from the standard-normal draw ``eps``."""
    mean, logvar = gaussian_moments(latent)
    return mean + torch.exp(0.5 * logvar) * eps


def gaussian_kl(latent: torch.Tensor) -> torch.Tensor:
    mean, logvar = gaussian_moments(latent)
    return 0.5 * torch.mean(torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar, dim=-1))


# -- hinge losses ----------------------------------------------------------------
def generator_loss(disc: nn.Module, fake: torch.Tensor) -> torch.Tensor:
    """fake [B,3,H,W]."""
    return -torch.mean(disc(fake))


def discriminator_loss(disc: nn.Module, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """real, fake [B,3,H,W], detached here."""
    return 0.5 * (torch.mean(F.relu(1.0 - disc(real.detach())))
                  + torch.mean(F.relu(1.0 + disc(fake.detach()))))
