"""Fixed-camera rig for DreamMat training (counterpart of
``dreammat_tpu/data/cameras.py``): half the views uniform in elevation
degrees, half area-uniform on the sphere, stratified azimuths, random
distance and fov per view. Host-side numpy from a seed, so both packages
draw the same rig."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
