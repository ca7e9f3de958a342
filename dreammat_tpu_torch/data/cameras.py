"""Cameras for DreamMat (counterpart of ``dreammat_tpu/data/cameras.py``).

The fixed training rig: half the views uniform in elevation degrees, half
area-uniform on the sphere, stratified azimuths, random distance and fov
per view, host-side numpy from a seed, so both packages draw the same rig.
The eval circle at one elevation, distance and fov, and one view's rays and
matrices (``camera_rays_and_matrices``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dreammat_tpu_torch.utils import ops as uops
from dreammat_tpu_torch.utils.hw import resolve_device


@dataclass
class CameraSet:
    elevation_deg: np.ndarray     # [N]
    azimuth_deg: np.ndarray       # [N]
    camera_distances: np.ndarray  # [N]
    fovy_deg: np.ndarray          # [N]

    def __len__(self):
        return len(self.elevation_deg)


def make_fixed_cameras(n_views: int, elevation_range=(-20.0, 45.0),
                       azimuth_range=(-180.0, 180.0), camera_distance_range=(3.0, 4.0),
                       fovy_range=(25.0, 45.0), seed: int = 0) -> CameraSet:
    rng = np.random.RandomState(seed)
    half = n_views // 2
    elev1 = rng.rand(half) * (elevation_range[1] - elevation_range[0]) + elevation_range[0]
    pct = [(elevation_range[0] + 90.0) / 180.0, (elevation_range[1] + 90.0) / 180.0]
    elev2 = np.rad2deg(np.arcsin(2 * (rng.rand(n_views - half) * (pct[1] - pct[0]) + pct[0]) - 1.0))
    elevation = np.concatenate([elev1, elev2])
    azimuth = (rng.rand(n_views) + np.arange(n_views)) / n_views * (
        azimuth_range[1] - azimuth_range[0]) + azimuth_range[0]
    dist = rng.rand(n_views) * (camera_distance_range[1] - camera_distance_range[0]) \
        + camera_distance_range[0]
    fovy = rng.rand(n_views) * (fovy_range[1] - fovy_range[0]) + fovy_range[0]
    return CameraSet(elevation.astype(np.float32), azimuth.astype(np.float32),
                     dist.astype(np.float32), fovy.astype(np.float32))


def make_eval_cameras(n_views: int = 120, elevation_deg: float = 15.0,
                      camera_distance: float = 4.0, fovy_deg: float = 30.0) -> CameraSet:
    """The eval circle: ``n_views`` azimuths evenly over [-180, 180)."""
    azimuth = np.linspace(-180.0, 180.0, n_views, endpoint=False)
    return CameraSet(np.full(n_views, elevation_deg, dtype=np.float32), azimuth.astype(np.float32),
                     np.full(n_views, camera_distance, dtype=np.float32),
                     np.full(n_views, fovy_deg, dtype=np.float32))


def camera_rays_and_matrices(cam: CameraSet, i: int, height: int, width: int, device="cuda"):
    """View ``i``'s rays_o / rays_d [H,W,3] and mvp / w2c / c2w [4,4] on
    ``device``, with its camera position and parameters."""
    device = resolve_device(device)
    pos = uops.camera_position_from_spherical(
        float(cam.elevation_deg[i]), float(cam.azimuth_deg[i]),
        float(cam.camera_distances[i])).to(device)
    c2w = uops.get_c2w(pos[None])
    fovy = np.deg2rad(float(cam.fovy_deg[i]))
    proj = uops.get_projection_matrix(torch.tensor([fovy], device=device), width / height,
                                      0.1, 1000.0)
    mvp, w2c = uops.get_mvp_matrix(c2w, proj)
    focal = 0.5 * height / np.tan(0.5 * fovy)
    dirs = uops.get_ray_directions(height, width, float(focal), device=device)
    rays_o, rays_d = uops.get_rays(dirs, c2w[0], keepdim=True)
    return {
        "rays_o": rays_o, "rays_d": rays_d, "mvp_mtx": mvp[0], "w2c": w2c[0], "c2w": c2w[0],
        "camera_position": pos,
        "elevation": float(cam.elevation_deg[i]), "azimuth": float(cam.azimuth_deg[i]),
        "camera_distance": float(cam.camera_distances[i]), "fovy_deg": float(cam.fovy_deg[i]),
    }
