"""CO3D capture datamodule: one sequence of posed frames, masks and depths.

Counterpart of ``co3d-datamodule`` in ``dreammat_tpu/data/co3d.py``, with
its own copy of the numpy preprocessing. ``setup`` reads the sequence's
frames from the dataset's ``frame_annotations.jgz`` (``<root>/..``; paths
relative to ``<root>/../..``), the 16-bit depth PNGs (float16 bytes),
the masks, and turns each PyTorch3D camera into OpenCV intrinsics (the v2
NDC-isotropic convention first, ``v2_mode``) and a c2w. It drops size and
position outliers, normalises the camera cloud with
``similarity_from_cameras`` (up along +z, the optical axes' median foot at
the origin, the median distance ``scale_radius``, then times
``cam_scale_factor``), crops each frame to its mask's box with
``box_crop_context`` around it, and pads it into ``height`` x ``width``
(``resize_with_pad``, PIL bilinear per channel). A training batch is one
frame's rays (made per call in numpy, float32; held as tensors on the
device), picked with the module's ``RandomState``, plus a sampled camera
of the embedded ``random-camera-datamodule`` (``random_camera``). Eval
replays that module's circle (``render_path: circle``) or the frames.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


def load_16bit_png_depth(path: str) -> np.ndarray:
    """A CO3D depth PNG: its 16-bit pixels read as float16."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.frombuffer(np.asarray(img, np.uint16).tobytes(), np.float16)
        return arr.astype(np.float32).reshape(img.size[1], img.size[0])


def load_depth(path: str, scale_adjustment: float) -> np.ndarray:
    d = load_16bit_png_depth(path) * scale_adjustment
    d[~np.isfinite(d)] = 0.0
    return d


def get_bbox_from_mask(mask: np.ndarray, thr: float, decrease_quant: float = 0.05):
    """xywh box of the mask above ``thr``, lowering ``thr`` until it holds
    more than one pixel (the whole frame when it never does)."""
    m = np.zeros_like(mask)
    while m.sum() <= 1.0 and thr > 0.0:
        m = (mask > thr).astype(np.float32)
        thr -= decrease_quant
    if m.sum() <= 1.0:
        return 0, 0, mask.shape[1], mask.shape[0]
    xs = np.nonzero(m.sum(axis=0))[0]
    ys = np.nonzero(m.sum(axis=1))[0]
    return xs[0], ys[0], xs[-1] - xs[0], ys[-1] - ys[0]


def clamp_bbox(bbox, context: float = 0.0) -> np.ndarray:
    """xywh -> xyxy, widened by ``context`` of its size."""
    b = np.asarray(bbox, np.float32)
    if context > 0:
        b[0] -= b[2] * context / 2
        b[1] -= b[3] * context / 2
        b[2] += b[2] * context
        b[3] += b[3] * context
    b[2:] = np.maximum(b[2:], 2)
    b[2:] += b[:2] + 1
    return b


def crop_box(arr: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    b = bbox.copy()
    b[[0, 2]] = np.clip(b[[0, 2]], 0, arr.shape[1])
    b[[1, 3]] = np.clip(b[[1, 3]], 0, arr.shape[0])
    b = b.round().astype(np.int64)
    return arr[b[1]:b[3], b[0]:b[2]]


def resize_with_pad(img: np.ndarray, height: int, width: int):
    """Aspect-preserving resize into the top-left of a zero canvas:
    (canvas [height, width, C], scale)."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = min(height / h, width / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    chans = img.shape[2] if img.ndim == 3 else 1
    src = img.reshape(h, w, chans)
    out = np.zeros((height, width, chans), np.float32)
    for c in range(chans):
        p = Image.fromarray(src[..., c].astype(np.float32), mode="F")
        out[:nh, :nw, c] = np.asarray(p.resize((nw, nh), Image.BILINEAR))
    return out, scale


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The smallest rotation taking unit ``a`` onto unit ``b`` (Rodrigues
    about a x b; a half turn about x when they are opposite)."""
    v = np.cross(a, b)
    s2 = float(v @ v)
    c = float(a @ b)
    if s2 < 1e-24:
        return np.eye(3) if c > 0.0 else np.diag([-1.0, 1.0, 1.0])
    vx = np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])
    return np.eye(3) + vx + vx @ vx * ((1.0 - c) / s2)


def similarity_from_cameras(c2w: np.ndarray, radius: float = 1.0):
    """(4x4 rigid transform, scale) normalising an OpenCV camera cloud: the
    mean camera up (-y of each rotation) turned to +z, the median over
    cameras of the foot of the perpendicular from the origin onto each
    optical axis moved to the origin, the median camera distance scaled to
    ``radius``."""
    rot = c2w[:, :3, :3]
    pos = c2w[:, :3, 3]
    mean_up = -rot[:, :, 1].mean(axis=0)
    mean_up /= np.linalg.norm(mean_up) + 1e-12
    R_align = _rotation_between(mean_up, np.array([0.0, 0.0, 1.0]))
    pos = pos @ R_align.T
    fwd = rot[:, :, 2] @ R_align.T
    foot = pos - (pos * fwd).sum(axis=1, keepdims=True) * fwd
    center = np.median(foot, axis=0)
    transform = np.eye(4)
    transform[:3, :3] = R_align
    transform[:3, 3] = -center
    scale = radius / np.median(np.linalg.norm(pos - center, axis=1))
    return transform, scale


@dreammat_tpu_torch.register("co3d-datamodule")
class Co3dDataModule(BaseObject):
    @dataclass
    class Config:
        root_dir: str = ""
        batch_size: int = 1
        height: int = 256
        width: int = 256
        cam_scale_factor: float = 0.95
        max_num_frames: int = 300
        v2_mode: bool = True
        use_mask: bool = True
        box_crop: bool = True
        box_crop_mask_thr: float = 0.4
        box_crop_context: float = 0.3
        scale_radius: float = 1.0
        use_random_camera: bool = True
        random_camera: dict = field(default_factory=dict)
        render_path: str = "circle"
        n_test_views: int = 30
        seed: int = 0
        # the reference's preprocessing-cache and split keys (every inlier
        # frame is served)
        load_preprocessed: bool = False
        train_num_rays: int = -1
        train_views: Optional[list] = None
        train_split: str = "train"
        val_split: str = "val"
        test_split: str = "test"
        rays_noise_scale: float = 0.0

    cfg: Config

    def configure(self, renderer=None, material=None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.renderer = renderer
        self.material = material
        self.rng = np.random.RandomState(self.cfg.seed)
        self.inner = None
        if self.cfg.use_random_camera:
            rc = dict(self.cfg.random_camera)
            rc.setdefault("height", self.cfg.height)
            rc.setdefault("width", self.cfg.width)
            rc.setdefault("use_fix_views", False)
            self.inner = dreammat_tpu_torch.find("random-camera-datamodule")(
                rc, renderer, material, device=self.device)

    # -- loading -------------------------------------------------------------
    def _read_frames(self):
        """(images, depths, masks, c2ws [F,4,4], focals, principal points,
        sizes) of the sequence's seen frames."""
        cfg = self.cfg
        seq = os.path.basename(os.path.normpath(cfg.root_dir))
        ann = os.path.join(cfg.root_dir, "..", "frame_annotations.jgz")
        with gzip.open(ann, "r") as fp:
            frames = [f for f in json.load(fp) if f["sequence_name"] == seq]
        if not frames:
            raise ValueError(f"sequence {seq!r} not found in {ann}")
        from PIL import Image

        base = os.path.join(cfg.root_dir, "..", "..")
        cam_trans = np.diag(np.array([-1, -1, 1, 1], np.float32))
        imgs, depths, masks, c2ws, focals, prps, sizes = [], [], [], [], [], [], []
        for fr in frames:
            if "unseen" in fr.get("meta", {}).get("frame_type", ""):
                continue
            img = np.asarray(Image.open(os.path.join(base, fr["image"]["path"])).convert("RGB"),
                             np.float32) / 255.0
            H, W = fr["image"]["size"]
            fxy = np.array(fr["viewpoint"]["focal_length"], np.float32)
            cxy = np.array(fr["viewpoint"]["principal_point"], np.float32)
            R = np.array(fr["viewpoint"]["R"], np.float32)
            T = np.array(fr["viewpoint"]["T"], np.float32)
            if cfg.v2_mode:
                # NDC-isotropic -> NDC
                half = np.array([W * 0.5, H * 0.5], np.float32)
                s = np.array([min(W, H) * 0.5] * 2, np.float32)
                fxy_x = fxy * s
                cxy = (half - (half - cxy * s)) / half
                fxy = fxy_x / half
            s = np.array([W * 0.5, H * 0.5], np.float32)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R
            pose[:3, 3:] = -R @ T[..., None]
            depth = None
            if "depth" in fr and fr["depth"].get("path"):
                p = os.path.join(base, fr["depth"]["path"])
                if os.path.exists(p):
                    depth = load_depth(p, fr["depth"]["scale_adjustment"])
            if cfg.use_mask and "mask" in fr and fr["mask"].get("path"):
                mask = np.asarray(Image.open(os.path.join(base, fr["mask"]["path"])),
                                  np.float32) / 255.0
            else:
                mask = np.ones(img.shape[:2], np.float32)
            imgs.append(img)
            depths.append(depth if depth is not None else np.zeros(img.shape[:2], np.float32))
            masks.append(mask)
            c2ws.append(pose @ cam_trans)  # PyTorch3D -> OpenCV
            focals.append(fxy * s)
            prps.append(-1.0 * (cxy - 1.0) * s)
            sizes.append((H, W))
        return imgs, depths, masks, np.stack(c2ws), focals, prps, sizes

    def setup(self) -> None:
        cfg = self.cfg
        imgs, depths, masks, c2ws, focals, prps, sizes = self._read_frames()
        sizes_a = np.asarray(sizes, np.float32)
        medHW = np.median(sizes_a, axis=0)
        inlier = (np.abs(sizes_a - medHW) / medHW < 0.1).all(axis=1)
        d = np.linalg.norm(c2ws[:, :3, 3] - np.median(c2ws[:, :3, 3], axis=0), axis=-1)
        inlier &= d < np.median(d) * 5.0
        if inlier.sum() == 0:
            inlier[:] = True
        keep = np.nonzero(inlier)[0][:cfg.max_num_frames]

        T_sim, sscale = similarity_from_cameras(c2ws[keep], radius=cfg.scale_radius)
        c2ws = T_sim @ c2ws[keep]
        c2ws[:, :3, 3] *= sscale * cfg.cam_scale_factor

        self.frames = []
        for j, i in enumerate(keep):
            img, depth, mask = imgs[i], depths[i] * sscale * cfg.cam_scale_factor, masks[i]
            fx, fy = focals[i]
            cx, cy = prps[i]
            if cfg.box_crop:
                bb = clamp_bbox(np.asarray(get_bbox_from_mask(mask, cfg.box_crop_mask_thr)),
                                cfg.box_crop_context)
                img = crop_box(img, bb)
                depth = crop_box(depth[..., None], bb)[..., 0]
                mask = crop_box(mask[..., None], bb)[..., 0]
                cx, cy = cx - bb[0], cy - bb[1]
            img, scl = resize_with_pad(img, cfg.height, cfg.width)
            depth, _ = resize_with_pad(depth[..., None], cfg.height, cfg.width)
            mask, _ = resize_with_pad(mask[..., None], cfg.height, cfg.width)
            self.frames.append({"rgb": img, "depth": depth[..., 0], "mask": mask[..., 0],
                                "c2w": c2ws[j], "fx": fx * scl, "fy": fy * scl,
                                "cx": cx * scl, "cy": cy * scl})
        self.n_frames = len(self.frames)
        if self.inner is not None:
            self.inner.setup()

    # -- rays ----------------------------------------------------------------
    def _frame_rays(self, fr):
        """(origins, directions) [H,W,3] of a frame, OpenCV pinhole (x right,
        y down, z forward), float32 numpy."""
        cfg = self.cfg
        i, j = np.meshgrid(np.arange(cfg.width, dtype=np.float32) + 0.5,
                           np.arange(cfg.height, dtype=np.float32) + 0.5, indexing="xy")
        dirs = np.stack([(i - fr["cx"]) / fr["fx"], (j - fr["cy"]) / fr["fy"],
                         np.ones_like(i)], -1)
        c2w = fr["c2w"]
        rd = dirs @ c2w[:3, :3].T
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True) + 1e-12
        return np.broadcast_to(c2w[:3, 3], rd.shape), rd

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=self.device)

    def frame_batch(self, idx: int) -> Dict[str, Any]:
        cfg = self.cfg
        fr = self.frames[idx]
        ro, rd = self._frame_rays(fr)
        n = cfg.height * cfg.width
        rgb = self._t(fr["rgb"])
        return {
            "index": idx,
            "rays_o": self._t(ro.reshape(-1, 3)),
            "rays_d": self._t(rd.reshape(-1, 3)),
            "light_positions": self._t(fr["c2w"][:3, 3])[None].expand(n, 3),
            "rgb": rgb,
            "gt_rgb": rgb,
            "mask": self._t(fr["mask"][..., None]),
            "ref_depth": self._t(fr["depth"][..., None]),
            "height": cfg.height,
            "width": cfg.width,
            "elevation": self._t([0.0]),
            "azimuth": self._t([0.0]),
            "camera_distances": self._t([np.linalg.norm(fr["c2w"][:3, 3])]),
        }

    def collate(self, step: int = 0) -> Dict[str, Any]:
        b = self.frame_batch(int(self.rng.randint(self.n_frames)))
        if self.inner is not None:
            b["random_camera"] = self.inner._collate_rays(step)
        return b

    # -- eval ----------------------------------------------------------------
    def eval_rays(self, i: int) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.render_path == "circle" and self.inner is not None:
            return self.inner.eval_rays(i)
        fr = self.frames[i % self.n_frames]
        ro, rd = self._frame_rays(fr)
        return {
            "rays_o": self._t(ro),
            "rays_d": self._t(rd),
            "light_position": self._t(fr["c2w"][:3, 3]),
            "elevation": self._t([0.0]),
            "azimuth": self._t([0.0]),
        }
