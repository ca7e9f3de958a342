"""Single-image data module: one fixed reference view and random novel views.

Counterpart of ``single-image-datamodule`` in ``dreammat_tpu/data/image.py``:
the reference RGBA image (LANCZOS-resized to width x height; RGB and the
mask alpha > 0.5), with its optional ``_depth.png`` and ``_normal.png``
side files (``requires_depth`` / ``requires_normal``, the image path's
``_rgba.png`` replaced), seen from a fixed camera (``default_*``: the
look-at camera at that elevation, azimuth and distance, z up); and an
embedded ``random-camera-datamodule`` in rays-only mode (``random_camera``
overrides its config; height, width, the eval size and ``n_test_views``
default to this module's) for the guidance's views and the eval circle.

``collate`` gives the reference view's rays [H*W,3], light positions (the
camera's position), ``rgb`` [H,W,3], ``mask`` [H,W,1], ``ref_depth``
[H,W,1] and ``ref_normal`` [H,W,3] where required, and a
``random_camera`` sub-batch (the embedded module's ``collate``). With
``rays_noise_scale`` > 0 the reference rays' directions are jittered once
by ``rays_noise_scale`` times the ``rays_noise`` draw [H,W,3] (normal) and
renormalized; the configs set it to 0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.utils import ops as uops
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.rng import TorchDraws


def _load(path: str, width: int, height: int, mode: Optional[str] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if mode is not None:
        img = img.convert(mode)
    arr = np.asarray(img.resize((width, height), Image.LANCZOS), dtype=np.float32) / 255.0
    return arr[..., None] if arr.ndim == 2 else arr


@dreammat_tpu_torch.register("single-image-datamodule")
class SingleImageDataModule(BaseObject):
    @dataclass
    class Config:
        height: int = 96
        width: int = 96
        default_elevation_deg: float = 0.0
        default_azimuth_deg: float = -180.0
        default_camera_distance: float = 1.2
        default_fovy_deg: float = 60.0
        image_path: str = ""
        use_random_camera: bool = True
        random_camera: dict = field(default_factory=dict)
        rays_noise_scale: float = 2e-3
        batch_size: int = 1
        requires_depth: bool = False
        requires_normal: bool = False
        resolution_milestones: Any = None  # accepted; one size is trained
        n_test_views: int = 120
        eval_height: Optional[int] = None
        eval_width: Optional[int] = None
        seed: int = 0

    cfg: Config

    def configure(self, renderer=None, material=None, device="cuda", draws=None) -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        rc = dict(cfg.random_camera)
        rc.setdefault("height", cfg.height)
        rc.setdefault("width", cfg.width)
        rc.setdefault("eval_height", cfg.eval_height or cfg.height)
        rc.setdefault("eval_width", cfg.eval_width or cfg.width)
        rc.setdefault("n_test_views", cfg.n_test_views)
        rc.setdefault("use_fix_views", False)
        self.inner = dreammat_tpu_torch.find("random-camera-datamodule")(
            rc, renderer, material, device=self.device)
        if not self.inner._rays_only:
            raise ValueError("single-image-datamodule needs a volume renderer or the rasterizer")

        elev = np.deg2rad(cfg.default_elevation_deg)
        azim = np.deg2rad(cfg.default_azimuth_deg)
        d = cfg.default_camera_distance
        pos = np.asarray([d * np.cos(elev) * np.cos(azim), d * np.cos(elev) * np.sin(azim),
                          d * np.sin(elev)], np.float32)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        c2w = uops.get_c2w(t(pos)[None], torch.zeros(1, 3, device=self.device),
                           t([[0.0, 0.0, 1.0]]))[0]
        focal = 0.5 * cfg.height / np.tan(0.5 * np.deg2rad(cfg.default_fovy_deg))
        dirs = uops.get_ray_directions(cfg.height, cfg.width, float(focal), device=self.device)
        rays_o, rays_d = uops.get_rays(dirs, c2w, keepdim=True)
        if cfg.rays_noise_scale > 0:
            draws = draws if draws is not None else TorchDraws(cfg.seed, self.device)
            noise = draws.normal("rays_noise", tuple(rays_d.shape)).to(self.device)
            rays_d = rays_d + noise * cfg.rays_noise_scale
            rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        self.ref_rays_o = rays_o.reshape(-1, 3)
        self.ref_rays_d = rays_d.reshape(-1, 3)
        self.ref_position = t(pos)
        self.c2w = c2w
        self.rgb = self.mask = self.depth = self.normal = None

    def setup(self) -> None:
        cfg = self.cfg
        if not cfg.image_path or not os.path.exists(cfg.image_path):
            raise FileNotFoundError(f"image_path {cfg.image_path!r} not found")
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)
        rgba = _load(cfg.image_path, cfg.width, cfg.height, "RGBA")
        self.rgb = t(rgba[..., :3])
        self.mask = t((rgba[..., 3:] > 0.5).astype(np.float32))
        if cfg.requires_depth:
            p = cfg.image_path.replace("_rgba.png", "_depth.png")
            self.depth = t(_load(p, cfg.width, cfg.height)[..., :1])
        if cfg.requires_normal:
            p = cfg.image_path.replace("_rgba.png", "_normal.png")
            self.normal = t(_load(p, cfg.width, cfg.height)[..., :3])
        self.inner.setup()

    def ref_batch(self) -> Dict[str, Any]:
        cfg = self.cfg
        f32 = lambda x: torch.tensor([float(x)], dtype=torch.float32, device=self.device)
        b = {"rays_o": self.ref_rays_o, "rays_d": self.ref_rays_d,
             "light_positions": self.ref_position[None].expand(cfg.height * cfg.width, 3),
             "height": cfg.height, "width": cfg.width,
             "elevation": f32(cfg.default_elevation_deg), "azimuth": f32(cfg.default_azimuth_deg),
             "camera_distances": f32(cfg.default_camera_distance),
             "rgb": self.rgb, "mask": self.mask}
        if self.depth is not None:
            b["ref_depth"] = self.depth
        if self.normal is not None:
            b["ref_normal"] = self.normal
        return b

    def collate(self, step: int = 0) -> Dict[str, Any]:
        batch = self.ref_batch()
        if self.cfg.use_random_camera:
            batch["random_camera"] = self.inner.collate(step)
        return batch

    def eval_rays(self, i: int) -> Dict[str, Any]:
        """View ``i`` of the embedded module's eval circle."""
        return self.inner.eval_rays(i)
