"""Environment lighting: procedural skies, equirect lookup, the FG LUT.

Counterpart of the parts of ``dreammat_tpu/ops/envmap.py`` the tables regime
uses: ``make_procedural_envmap`` (numpy, used when no HDR asset exists),
``resize_envmap``, equirect sampling with z as the polar axis, and the
computed Karis split-sum LUT (``compute_fg_lut`` / ``sample_fg_lut``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dreammat_tpu_torch.utils import ops as uops


def make_procedural_envmap(height: int = 256, width: int = 512, sun_dir=(0.5, 0.5, 0.7),
                           sun_intensity: float = 20.0, sky_color=(0.35, 0.45, 0.65),
                           ground_color=(0.25, 0.2, 0.15), seed: int = 0) -> np.ndarray:
    """Analytic sky + sun equirect map [H,W,3] float32."""
    v, u = np.meshgrid(
        (np.arange(height) + 0.5) / height, (np.arange(width) + 0.5) / width, indexing="ij"
    )
    theta = v * np.pi
    phi = (0.5 - u) * 2 * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    sd = np.asarray(sun_dir, dtype=np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = (d * sd).sum(-1)
    sky_t = np.clip(d[..., 2] * 0.5 + 0.5, 0, 1)[..., None]
    base = sky_t * np.asarray(sky_color) + (1 - sky_t) * np.asarray(ground_color)
    sun = np.exp((cos_sun - 1.0) * 400.0)[..., None] * sun_intensity
    return (base + sun).astype(np.float32)


def resize_envmap(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H,W,3] -> [height,width,3], half-pixel bilinear with antialiasing
    when shrinking (what ``jax.image.resize(method="linear")`` does)."""
    if tuple(img.shape[:2]) == (height, width):
        return img
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)


def equirect_uv(directions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = uops.safe_normalize(directions)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    phi = torch.remainder(torch.atan2(y, x), 2.0 * math.pi)
    return -phi / (2.0 * math.pi) + 0.5, theta / math.pi


def sample_equirect_bilinear(env: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup with azimuth wrap. env [H,W,3]."""
    H, W = env.shape[0], env.shape[1]
    u, v = equirect_uv(directions)
    x = u * W - 0.5
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), W)
    x1i = torch.remainder(x0.long() + 1, W)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    return (env[y0i, x0i] * (1 - wx) * (1 - wy) + env[y0i, x1i] * wx * (1 - wy)
            + env[y1i, x0i] * (1 - wx) * wy + env[y1i, x1i] * wx * wy)


def _hammersley(n: int):
    i = np.arange(n)
    u1 = (i + 0.5) / n
    bits = i.astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    u2 = bits.astype(np.float64) * 2.3283064365386963e-10
    return u1.astype(np.float32), u2.astype(np.float32)


def compute_fg_lut(res: int = 256, n_samples: int = 512, device="cpu",
                   row_chunk: int = 32) -> torch.Tensor:
    """Karis split-sum (scale, bias) for F0 as a [res, res, 2] LUT indexed
    [NoV, linear roughness]; Hammersley-sampled GGX, Schlick-GGX geometry
    with k = alpha/2."""
    u1, u2 = (torch.as_tensor(a, device=device) for a in _hammersley(n_samples))
    phi = 2.0 * math.pi * u1                                     # [S]
    rough = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    a = (rough * rough)[:, None]                                 # [R,1]
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2 + 1e-9))  # [R,S]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, 0.0, 1.0))
    hx, hy, hz = torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t
    k = a / 2.0
    rows = []
    for s in range(0, res, row_chunk):
        nov = ((torch.arange(s, min(s + row_chunk, res), dtype=torch.float32, device=device)
                + 0.5) / res)[:, None, None]                     # [n,1,1]
        vx = torch.sqrt(1.0 - nov * nov)
        voh_raw = vx * hx + nov * hz                             # V.H, [n,R,S]
        lz = 2.0 * voh_raw * hz - nov
        NoL = torch.clamp(lz, 0.0, 1.0)
        NoH = torch.clamp(hz, 0.0, 1.0)
        VoH = torch.clamp(voh_raw, 0.0, 1.0)
        g1 = NoL / (NoL * (1 - k) + k + 1e-7)
        g2 = nov / (nov * (1 - k) + k + 1e-7)
        G_vis = g1 * g2 * VoH / (NoH * nov + 1e-7)
        Fc = (1.0 - VoH) ** 5
        valid = NoL > 0
        A = torch.where(valid, (1 - Fc) * G_vis, torch.zeros_like(G_vis)).mean(-1)
        B = torch.where(valid, Fc * G_vis, torch.zeros_like(G_vis)).mean(-1)
        rows.append(torch.stack([A, B], dim=-1))
    return torch.cat(rows)


def sample_fg_lut(lut: torch.Tensor, n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear LUT fetch; inputs [...,1] clamped to [0,1]; out [...,2]."""
    res = lut.shape[0]
    u = torch.clamp(n_dot_v[..., 0], 0.0, 1.0) * (res - 1)
    v = torch.clamp(roughness[..., 0], 0.0, 1.0) * (res - 1)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, 0, res - 1)
    v1 = torch.clamp(v0 + 1, 0, res - 1)
    wu = (u - u0)[..., None]
    wv = (v - v0)[..., None]
    return (lut[u0, v0] * (1 - wu) * (1 - wv) + lut[u1, v0] * wu * (1 - wv)
            + lut[u0, v1] * (1 - wu) * wv + lut[u1, v1] * wu * wv)
