"""Multiview posed-image datamodule (nerfstudio ``transforms.json`` layout).

Counterpart of ``multiview-camera-datamodule`` in
``dreammat_tpu/data/multiview.py``: a captured scene as frames with
per-frame OPENCV intrinsics and extrinsics. ``setup`` reads the frames
(every ``train_data_interval``-th), downsamples them by
``train_downsample_resolution``, recentres the cameras (``around``) or also
pushes them back along the mean view direction (``front``), turns the
poses from OPENCV to OpenGL and makes each frame's rays in numpy (float32,
as the JAX package does), then holds rays and images as tensors on the
device. A training batch is one frame, picked by the module's
``RandomState``; eval replays the frames or slerps between two of them
(``eval_interpolation`` (a, b, n), scipy's ``Slerp`` in world-to-camera
space, frame a's intrinsics).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


def convert_pose(c2w: np.ndarray) -> np.ndarray:
    """OPENCV -> OpenGL camera convention."""
    flip = np.eye(4, dtype=np.float32)
    flip[1, 1] = -1.0
    flip[2, 2] = -1.0
    return c2w @ flip


def inter_pose(pose_0: np.ndarray, pose_1: np.ndarray, ratio: float) -> np.ndarray:
    """Slerp of the rotation and lerp of the translation between two c2w
    poses, in world-to-camera space."""
    from scipy.spatial.transform import Rotation as Rot
    from scipy.spatial.transform import Slerp

    p0 = np.linalg.inv(pose_0)
    p1 = np.linalg.inv(pose_1)
    rots = Rot.from_matrix(np.stack([p0[:3, :3], p1[:3, :3]]))
    rot = Slerp([0, 1], rots)(ratio)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot.as_matrix()
    pose[:3, 3] = ((1.0 - ratio) * p0 + ratio * p1)[:3, 3]
    return np.linalg.inv(pose).astype(np.float32)


def ray_directions(H: int, W: int, fx, fy, cx, cy) -> np.ndarray:
    """Camera-space directions [H,W,3] through the pixel centres (OpenGL: y
    up, looking down -z)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                       np.arange(H, dtype=np.float32) + 0.5, indexing="xy")
    return np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)


def _world_rays(dirs: np.ndarray, c2w: np.ndarray):
    rd = dirs @ c2w[:3, :3].T
    rd = rd / (np.linalg.norm(rd, axis=-1, keepdims=True) + 1e-8)
    return np.broadcast_to(c2w[:3, 3], rd.shape), rd


@dreammat_tpu_torch.register("multiview-camera-datamodule")
class MultiviewDataModule(BaseObject):
    @dataclass
    class Config:
        dataroot: str = ""
        train_downsample_resolution: int = 4
        eval_downsample_resolution: int = 4
        train_data_interval: int = 1
        eval_data_interval: int = 1
        batch_size: int = 1
        eval_batch_size: int = 1
        camera_layout: str = "around"
        camera_distance: float = -1.0
        eval_interpolation: Optional[Tuple[int, int, int]] = None
        n_test_views: int = 0  # 0: every loaded frame
        seed: int = 0

    cfg: Config

    def configure(self, renderer=None, material=None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.renderer = renderer
        self.material = material
        self.rng = np.random.RandomState(self.cfg.seed)

    def setup(self) -> None:
        cfg = self.cfg
        with open(os.path.join(cfg.dataroot, "transforms.json")) as f:
            cam = json.load(f)
        if cam.get("camera_model", "OPENCV") != "OPENCV":
            raise ValueError("only the OPENCV camera model is supported")
        frames = cam["frames"][::max(cfg.train_data_interval, 1)]
        scale = cfg.train_downsample_resolution
        self.H = int(frames[0]["h"]) // scale
        self.W = int(frames[0]["w"]) // scale

        c2ws = np.stack([np.asarray(f["transform_matrix"], np.float32) for f in frames])
        c2ws[:, :3, 3] -= c2ws[:, :3, 3].mean(axis=0, keepdims=True)
        if cfg.camera_layout == "front":
            if cfg.camera_distance <= 0:
                raise ValueError("camera_layout 'front' needs camera_distance > 0")
            z = np.zeros((len(frames), 3, 1), np.float32)
            z[:, 2, :] = -1.0
            rot_z = (c2ws[:, :3, :3] @ z).mean(axis=0)[None]
            c2ws[:, :3, 3] -= rot_z[:, :, 0] * cfg.camera_distance
        elif cfg.camera_layout != "around":
            raise ValueError(f"unknown camera layout {cfg.camera_layout}")

        from PIL import Image

        rays_o, rays_d, imgs, positions, self.c2ws = [], [], [], [], []
        for idx, frame in enumerate(frames):
            fx, fy = frame["fl_x"] / scale, frame["fl_y"] / scale
            cx, cy = frame["cx"] / scale, frame["cy"] / scale
            img = Image.open(os.path.join(cfg.dataroot, frame["file_path"])).convert("RGB")
            imgs.append(np.asarray(img.resize((self.W, self.H)), np.float32) / 255.0)
            c2w = convert_pose(c2ws[idx])
            self.c2ws.append(c2w)
            ro, rd = _world_rays(ray_directions(self.H, self.W, fx, fy, cx, cy), c2w)
            rays_o.append(ro.reshape(-1, 3))
            rays_d.append(rd.reshape(-1, 3))
            positions.append(c2w[:3, 3])
        t = lambda x: torch.as_tensor(np.ascontiguousarray(np.stack(x)), dtype=torch.float32,
                                      device=self.device)
        self.rays_o, self.rays_d = t(rays_o), t(rays_d)     # [F, H*W, 3]
        self.imgs = t(imgs)                                   # [F, H, W, 3]
        self.positions = np.stack(positions)                  # [F, 3], host
        self.n_frames = len(frames)
        if not cfg.n_test_views:
            cfg.n_test_views = self.n_frames

    def _f32(self, x) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=self.device)

    # -- batches -------------------------------------------------------------
    def frame_batch(self, i: int) -> Dict[str, Any]:
        n = self.H * self.W
        pos = self._f32(self.positions[i])
        return {
            "index": i,
            "rays_o": self.rays_o[i],
            "rays_d": self.rays_d[i],
            "light_positions": pos[None].expand(n, 3),
            "gt_rgb": self.imgs[i],
            "height": self.H,
            "width": self.W,
            "elevation": self._f32([0.0]),
            "azimuth": self._f32([0.0]),
            "camera_distances": self._f32([np.linalg.norm(self.positions[i])]),
        }

    def collate(self, step: int = 0) -> Dict[str, Any]:
        return self.frame_batch(int(self.rng.randint(self.n_frames)))

    # -- eval ----------------------------------------------------------------
    def eval_rays(self, i: int) -> Dict[str, Any]:
        """View ``i``: frame ``i mod F``, or the ``i``-th of ``n`` poses
        slerped from frame a to frame b."""
        cfg = self.cfg
        H, W = self.H, self.W
        if cfg.eval_interpolation is not None:
            a, b, n = cfg.eval_interpolation
            c2w = inter_pose(self.c2ws[a], self.c2ws[b], (i % n) / max(n - 1, 1))
            ro, rd = _world_rays(ray_directions(H, W, *self._frame_intrinsics(a)), c2w)
            ro, rd, pos = self._f32(np.ascontiguousarray(ro)), self._f32(rd), c2w[:3, 3]
        else:
            f = i % self.n_frames
            ro, rd, pos = self.rays_o[f], self.rays_d[f], self.positions[f]
        return {
            "rays_o": ro.reshape(H, W, 3),
            "rays_d": rd.reshape(H, W, 3),
            "light_position": self._f32(pos),
            "elevation": self._f32([0.0]),
            "azimuth": self._f32([0.0]),
        }

    def _frame_intrinsics(self, idx: int):
        """(fx, fy, cx, cy) of frame ``idx`` as the JAX package derives them
        for the slerped path: the focal lengths from the angles of frame
        ``idx``'s rays at the right and bottom edges, the centre at the
        image's middle."""
        H, W = self.H, self.W
        rd = self.rays_d[idx].cpu().numpy().reshape(H, W, 3)
        local = rd @ self.c2ws[idx][:3, :3]
        fx = (W / 2) / abs(local[H // 2, -1, 0] / local[H // 2, -1, 2])
        fy = (H / 2) / abs(local[-1, W // 2, 1] / local[-1, W // 2, 2])
        return fx, fy, W / 2, H / 2
