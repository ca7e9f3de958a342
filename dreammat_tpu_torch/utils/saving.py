"""Artifact writers: images, grids, gifs, OBJ/MTL meshes.

Counterpart of ``dreammat_tpu/utils/saving.py`` (RGB and grayscale images,
multi-panel grids, RGBA per-channel PNGs, turntable gifs, and the OBJ + MTL
+ texture-map writer of the export). The images are encoded by PIL (PNG,
JPEG at its default quality of 75, looping GIF89a), which is imported where
an image is written; the JAX package's gifs go through imageio, which the
port does not need.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np


def _to_uint8(img: np.ndarray, data_range=(0, 1)) -> np.ndarray:
    lo, hi = data_range
    x = (np.asarray(img, dtype=np.float32) - lo) / (hi - lo + 1e-12)
    x = np.nan_to_num(x)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _save(path: str, arr: np.ndarray) -> str:
    """uint8 [H,W], [H,W,3] or [H,W,4] to ``path``; PIL picks the format
    from the extension."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
    return path


def save_image(path: str, img: np.ndarray, data_range=(0, 1)) -> str:
    """img: [H,W,3|1] or [H,W], float or uint8; PNG, or JPEG for .jpg/.jpeg."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = _to_uint8(arr, data_range)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return _save(path, arr)


def save_image_with_alpha(path: str, img: np.ndarray, alpha: np.ndarray, data_range=(0, 1)) -> str:
    """RGBA PNG (the per-channel PBR saves of the test renders)."""
    rgb = _to_uint8(img, data_range)
    if rgb.ndim == 2 or rgb.shape[-1] == 1:
        rgb = np.repeat(rgb.reshape(*rgb.shape[:2], 1), 3, axis=-1)
    a = _to_uint8(alpha.reshape(*alpha.shape[:2], 1))
    return _save(path, np.concatenate([rgb, a], axis=-1))


def make_grid(rows: List[List[Dict[str, Any]]], border: int = 2) -> np.ndarray:
    """rows of {"img": [H,W,C], "data_range": (lo,hi)} panels -> one image."""
    panels_by_row = []
    for row in rows:
        panels = []
        for spec in row:
            arr = _to_uint8(np.asarray(spec["img"]), spec.get("data_range", (0, 1)))
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=-1)
            elif arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            panels.append(arr)
        h = max(p.shape[0] for p in panels)
        padded = [np.pad(p, ((0, h - p.shape[0]), (border, border), (0, 0)), constant_values=255)
                  for p in panels]
        panels_by_row.append(np.concatenate(padded, axis=1))
    w = max(r.shape[1] for r in panels_by_row)
    padded_rows = [np.pad(r, ((border, border), (0, w - r.shape[1]), (0, 0)), constant_values=255)
                   for r in panels_by_row]
    return np.concatenate(padded_rows, axis=0)


def save_image_grid(path: str, rows: List[List[Dict[str, Any]]]) -> str:
    return save_image(path, make_grid(rows), data_range=(0, 255))


def save_gif(path: str, frames: List[np.ndarray], fps: int = 30, data_range=(0, 1)) -> str:
    """A looping gif at ``fps``."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = [_to_uint8(f, data_range) for f in frames]
    ims = [Image.fromarray(a[..., 0] if a.ndim == 3 and a.shape[-1] == 1 else a) for a in arrs]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=1000.0 / fps, loop=0)
    return path


def _write_rows(f, fmt: str, rows: np.ndarray, chunk: int = 1 << 16) -> None:
    """Each row of ``rows`` through the %-format ``fmt``, written in chunks
    (one format call a chunk, not one a row)."""
    for s in range(0, len(rows), chunk):
        block = rows[s:s + chunk]
        f.write((fmt * len(block)) % tuple(block.reshape(-1).tolist()))


def save_obj_with_mtl(
    out_dir: str,
    name: str,
    v_pos: np.ndarray,
    t_pos_idx: np.ndarray,
    v_tex: Optional[np.ndarray] = None,
    t_tex_idx: Optional[np.ndarray] = None,
    v_nrm: Optional[np.ndarray] = None,
    albedo_map: Optional[np.ndarray] = None,
    metallic_map: Optional[np.ndarray] = None,
    roughness_map: Optional[np.ndarray] = None,
    bump_map: Optional[np.ndarray] = None,
) -> str:
    """OBJ + MTL with map_Kd / map_Pm / map_Pr (/ map_Bump), the keys the
    reference writes, and the maps as JPEGs beside them."""
    os.makedirs(out_dir, exist_ok=True)
    obj_path = os.path.join(out_dir, f"{name}.obj")
    mtl_name = f"{name}.mtl"
    F = np.asarray(t_pos_idx).astype(np.int64) + 1
    if v_tex is not None or v_nrm is not None:
        FT = (np.asarray(t_tex_idx) if t_tex_idx is not None else np.asarray(t_pos_idx))
        cols = [F, FT.astype(np.int64) + 1 if v_tex is not None else None,
                F if v_nrm is not None else None]
        corner = "/".join("%d" if c is not None else "" for c in cols)
        faces = np.stack([c for c in cols if c is not None], axis=-1).reshape(len(F), -1)
        face_fmt = "f " + " ".join([corner] * 3) + "\n"
    else:
        faces, face_fmt = F, "f %d %d %d\n"
    with open(obj_path, "w") as f:
        f.write(f"mtllib {mtl_name}\n")
        _write_rows(f, "v %.6f %.6f %.6f\n", np.asarray(v_pos))
        if v_tex is not None:
            vt = np.asarray(v_tex)
            _write_rows(f, "vt %.6f %.6f\n", np.stack([vt[:, 0], 1.0 - vt[:, 1]], axis=-1))
        if v_nrm is not None:
            _write_rows(f, "vn %.6f %.6f %.6f\n", np.asarray(v_nrm))
        f.write(f"usemtl {name}\n")
        _write_rows(f, face_fmt, faces)

    mtl = [f"newmtl {name}\n", "Ka 1.000 1.000 1.000\nKd 1.000 1.000 1.000\nKs 0.000 0.000 0.000\n"]
    for key, fname, m in (("map_Kd", "texture_kd.jpg", albedo_map),
                          ("map_Pm", "texture_metallic.jpg", metallic_map),
                          ("map_Pr", "texture_roughness.jpg", roughness_map),
                          ("map_Bump", "texture_nrm.jpg", bump_map)):
        if m is not None:
            save_image(os.path.join(out_dir, fname), m)
            mtl.append(f"{key} {fname}\n")
    with open(os.path.join(out_dir, mtl_name), "w") as f:
        f.writelines(mtl)
    return obj_path
