"""Small vector, camera and activation helpers on tensors.

Counterpart of ``dreammat_tpu/utils/ops.py`` for the functions the ported
path calls. Conventions are the same: world +z up, cameras from spherical
(elevation from the xy-plane, azimuth from +x toward +y), OpenGL cameras
looking down -z.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def dot(a, b, keepdim: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def saturate_dot(a, b):
    return torch.clamp(dot(a, b), 0.0, 1.0)


def safe_normalize(v, eps: float = 1e-8):
    """v * rsqrt(|v|^2 + eps^2): finite gradient at v = 0."""
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)


def reflect(view_dirs, normals):
    """Mirror ``view_dirs`` (pointing away from the surface) about ``normals``."""
    return dot(view_dirs, normals) * normals * 2.0 - view_dirs


def lin2srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308, x * 12.92, 1.055 * torch.pow(x + 1e-12, 1.0 / 2.4) - 0.055
    )


def get_activation(name):
    name = (name or "none").lower()
    table = {
        "none": lambda x: x,
        "identity": lambda x: x,
        "lin2srgb": lin2srgb,
        "exp": torch.exp,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softplus": F.softplus,
        "relu": F.relu,
    }
    if name in table:
        return table[name]
    raise ValueError(f"unknown activation '{name}'")


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def camera_position_from_spherical(elevation_deg, azimuth_deg, distance):
    """World-space camera positions [..., 3] (float32), z up."""
    el = torch.deg2rad(torch.as_tensor(elevation_deg, dtype=torch.float32))
    az = torch.deg2rad(torch.as_tensor(azimuth_deg, dtype=torch.float32))
    d = torch.as_tensor(distance, dtype=torch.float32)
    return torch.stack(
        [d * torch.cos(el) * torch.cos(az), d * torch.cos(el) * torch.sin(az),
         d * torch.sin(el)],
        dim=-1,
    )


def get_c2w(camera_positions):
    """Look-at-origin camera-to-world matrices [B,4,4], +z up."""
    pos = torch.atleast_2d(camera_positions)
    B = pos.shape[0]
    up = torch.tensor([0.0, 0.0, 1.0], device=pos.device).expand(B, 3)
    lookat = safe_normalize(-pos)
    right = safe_normalize(cross(lookat, up))
    up2 = safe_normalize(cross(right, lookat))
    rot = torch.stack([right, up2, -lookat], dim=-1)  # columns
    c2w = torch.cat([rot, pos[:, :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=pos.device).expand(B, 1, 4)
    return torch.cat([c2w, bottom], dim=1)


def get_w2c(c2w):
    """Invert a rigid camera-to-world: R' = R^T, t' = -R^T t."""
    rt = c2w[..., :3, :3].transpose(-1, -2)
    t = -(rt * c2w[..., None, :3, 3]).sum(-1)
    w2c = torch.zeros_like(c2w)
    w2c[..., :3, :3] = rt
    w2c[..., :3, 3] = t
    w2c[..., 3, 3] = 1.0
    return w2c


def get_orthogonal_directions(directions):
    """A unit tangent orthogonal to each direction."""
    x, y, z = directions[..., 0:1], directions[..., 1:2], directions[..., 2:3]
    zeros = torch.zeros_like(x)
    otho0 = torch.cat([y, -x, zeros], dim=-1)
    otho1 = torch.cat([-z, zeros, x], dim=-1)
    use0 = torch.linalg.norm(otho0, dim=-1, keepdim=True) > torch.linalg.norm(
        otho1, dim=-1, keepdim=True
    )
    return safe_normalize(torch.where(use0, otho0, otho1))


def sample_sphere_fibonacci(num_samples: int, begin_elevation: float = 0.0):
    """Fibonacci-spiral sphere samples as (azimuths, elevations) in radians,
    numpy float32."""
    ratio = (begin_elevation + 90.0) / 180.0
    num_points = int(num_samples // (1.0 - ratio))
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    n = np.arange(num_points - num_samples, num_points)
    z = 2.0 * n / num_points - 1.0
    azimuths = (2.0 * math.pi * n * phi) % (2.0 * math.pi)
    elevations = np.arcsin(z)
    return azimuths.astype("float32"), elevations.astype("float32")
