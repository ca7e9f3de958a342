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
        "scale_-11_01": lambda x: x * 0.5 + 0.5,
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


def get_c2w(camera_positions, center=None, up=None):
    """Look-at camera-to-world matrices [B,4,4]: each camera at
    ``camera_positions`` looks at ``center`` (default the origin) with
    ``up`` (default +z), all [B,3]."""
    pos = torch.atleast_2d(camera_positions)
    B = pos.shape[0]
    if up is None:
        up = torch.tensor([0.0, 0.0, 1.0], device=pos.device).expand(B, 3)
    lookat = safe_normalize(-pos if center is None else torch.atleast_2d(center) - pos)
    right = safe_normalize(cross(lookat, torch.atleast_2d(up)))
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


def get_ray_directions(H: int, W: int, focal: float, device="cpu"):
    """Camera-space ray directions [H,W,3] through pixel centres
    (cx = W/2, cy = H/2, y up, looking down -z)."""
    i = torch.arange(W, dtype=torch.float32, device=device) + 0.5
    j = torch.arange(H, dtype=torch.float32, device=device) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    return torch.stack([(ii - W / 2.0) / focal, -(jj - H / 2.0) / focal, -torch.ones_like(ii)],
                       dim=-1)


def get_rays(directions, c2w, keepdim: bool = False):
    """World rays (origins, unit directions) for camera-space
    ``directions`` [H,W,3] and one ``c2w`` [4,4]: each [H,W,3] with
    ``keepdim``, else [H*W,3]."""
    rays_d = safe_normalize((directions[..., None, :] * c2w[:3, :3]).sum(-1))
    rays_o = c2w[:3, 3].expand_as(rays_d)
    if not keepdim:
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    return rays_o, rays_d


def get_projection_matrix(fovy, aspect_wh: float, near: float, far: float):
    """OpenGL perspective with a y flip, [B,4,4]; ``fovy`` [B] radians."""
    fovy = torch.atleast_1d(torch.as_tensor(fovy, dtype=torch.float32))
    t = torch.tan(fovy / 2.0)
    proj = torch.zeros(fovy.shape[0], 4, 4, dtype=torch.float32, device=fovy.device)
    proj[:, 0, 0] = 1.0 / (t * aspect_wh)
    proj[:, 1, 1] = -1.0 / t
    proj[:, 2, 2] = -(far + near) / (far - near)
    proj[:, 2, 3] = -2.0 * far * near / (far - near)
    proj[:, 3, 2] = -1.0
    return proj


def get_mvp_matrix(c2w, proj):
    w2c = get_w2c(c2w)
    return proj @ w2c, w2c


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


def perpendicular_component(x, y):
    """The component of x orthogonal to y, per sample of the leading dim."""
    dims = tuple(range(1, x.dim()))
    num = torch.sum(x * y, dim=dims, keepdim=True)
    den = torch.sum(y * y, dim=dims, keepdim=True) + 1e-8
    return x - (num / den) * y


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
