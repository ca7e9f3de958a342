"""ControlNet training dataset: loading and generation.

Counterpart of ``dreammat_tpu/data/controlnet_dataset.py``
(``ControlNetExample``, ``ControlNetDataset``,
``generate_dataset_for_mesh``). Per item: the 22-channel
condition (depth 1 + normal 3 + 6 light probes x 3), the target color
render and the prompt, with the reference's CFG dropout schedule:

  p < 0.05          -> zero all conditions
  0.05 <= p < 0.10  -> zero depth
  0.10 <= p < 0.15  -> zero normal
  0.15 <= p < 0.20  -> zero probes
  0.20 <= p < 0.50  -> empty prompt

The dropout draws and the epoch permutations come from one
``np.random.RandomState(seed)`` in the same order as the JAX package, so the
two give identical batches. Two layouts: the native npz shard
``<root>/<obj>/data.npz`` and the reference's PNG directories
``<root>/<obj>/{color,depth,normal,light}/``. The npz loader keeps the arrays
of the object it read last in memory (the JAX loader re-reads the whole file
for every item), which changes no result.

``generate_dataset_for_mesh`` renders one mesh's ``data.npz``: the
prerender's depth, normal and probe maps of a fixed rig (kernel B casts the
G-buffers and the visibility bake on the card) and the colour of a
constant material under every environment, shaded by the Monte-Carlo
estimator with ``is_train=False`` (no random rotations, so it draws
nothing) over a white background. ``generate_controlnet_data_torch.py``
is its command line.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.hw import resolve_device

_PROBE_TAGS = ("m0.0r0.0", "m0.0r0.5", "m0.0r1.0", "m1.0r0.0", "m1.0r0.5", "m1.0r1.0")


@dataclass
class ControlNetExample:
    target: np.ndarray     # [H,W,3] float32 in [0,1]
    condition: np.ndarray  # [H,W,22] float32
    prompt: str


class ControlNetDataset:
    def __init__(self, root: str, prompt_file: str, resolution: int = 256,
                 use_cfg: bool = False, env_num: int = 5, view_num: int = 16,
                 seed: int = 0):
        self.root = root
        self.resolution = resolution
        self.use_cfg = use_cfg
        self.env_num = env_num
        self.view_num = view_num
        self.rng = np.random.RandomState(seed)
        with open(prompt_file) as f:
            prompts = json.load(f)
        self.obj_info = []
        for name, prompt in prompts.items():
            sub = os.path.join(root, name)
            if os.path.isdir(sub):
                self.obj_info.append({"path": sub, "prompt": prompt, "name": name})
        self.per_obj = env_num * view_num
        self._npz_path: Optional[str] = None
        self._npz: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.obj_info) * self.per_obj

    def _load_png_item(self, objpath: str, view: int, env: int):
        from PIL import Image

        dim = (self.resolution, self.resolution)

        def rgb(p):
            return np.asarray(Image.open(p).convert("RGB").resize(dim), dtype=np.float32) / 255.0

        img = Image.open(os.path.join(objpath, "color", f"{view:03d}_color_env{env}.png")).resize(dim)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.shape[-1] == 4:
            a = arr[..., 3:4]
            target = arr[..., :3] * a + (1 - a)  # white background, as the reference
        else:
            target = arr[..., :3]
        d = np.asarray(Image.open(os.path.join(objpath, "depth", f"{view:03d}.png")).resize(dim),
                       dtype=np.float32)
        d = d / 65535.0 if d.max() > 255 else d / 255.0
        depth = d.reshape(*dim, -1)[..., :1]
        normal = rgb(os.path.join(objpath, "normal", f"{view:03d}.png"))
        probes = [rgb(os.path.join(objpath, "light", f"{view:03d}_{tag}_env{env}.png"))
                  for tag in _PROBE_TAGS]
        return target, np.concatenate([depth, normal] + probes, axis=-1)

    def _npz_arrays(self, path: str) -> Dict[str, np.ndarray]:
        if path != self._npz_path:
            with np.load(path) as z:
                self._npz = {k: z[k] for k in ("colors", "depths", "normals", "lightmaps")}
            self._npz_path = path
        return self._npz

    def _load_npz_item(self, objpath: str, view: int, env: int):
        z = self._npz_arrays(os.path.join(objpath, "data.npz"))
        target = z["colors"][view, env - 1].astype(np.float32)
        cond = np.concatenate(
            [z["depths"][view], z["normals"][view], z["lightmaps"][view, env - 1]], axis=-1
        ).astype(np.float32)
        return target, cond

    def __getitem__(self, idx: int) -> ControlNetExample:
        obj = self.obj_info[idx // self.per_obj]
        rem = idx % self.per_obj
        env = rem // self.view_num + 1
        view = rem % self.view_num
        if os.path.exists(os.path.join(obj["path"], "data.npz")):
            target, cond = self._load_npz_item(obj["path"], view, env)
        else:
            target, cond = self._load_png_item(obj["path"], view, env)
        prompt = obj["prompt"]
        if self.use_cfg:
            p = self.rng.rand()
            if p < 0.05:
                cond = np.zeros_like(cond)
            elif p < 0.10:
                cond[..., 0] = 0.0
            elif p < 0.15:
                cond[..., 1:4] = 0.0
            elif p < 0.20:
                cond[..., 4:] = 0.0
            elif p < 0.50:
                prompt = ""
        return ControlNetExample(target, cond, prompt)

    def batches(self, batch_size: int, epochs: int = 1, shuffle: bool = True,
                shard: Tuple[int, int] = (0, 1)):
        """Yield dict batches of stacked arrays and prompt lists; a last
        partial batch of an epoch is dropped. With ``shard=(i, n)`` each
        batch of ``batch_size`` is cut into n blocks and only block i is
        read (one rank's rows; every rank draws the same order)."""
        index, count = shard
        if batch_size % count:
            raise ValueError(f"a batch of {batch_size} does not split over {count} ranks")
        per = batch_size // count
        n = len(self)
        for _ in range(epochs):
            order = self.rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                items = [self[int(j)] for j in order[i + index * per: i + (index + 1) * per]]
                yield {
                    "target": np.stack([it.target for it in items]),
                    "condition": np.stack([it.condition for it in items]),
                    "prompts": [it.prompt for it in items],
                }


def generate_dataset_for_mesh(
    mesh_path: str,
    out_dir: str,
    material_cfg: Optional[dict] = None,
    n_views: int = 16,
    n_envs: int = 5,
    resolution: int = 256,
    gt_material: Optional[Tuple[Tuple[float, float, float], float, float]] = None,
    seed: int = 0,
    renderer_cfg: Optional[dict] = None,
    device="cuda",
) -> str:
    """Render one mesh's condition maps (depth, normal, six probes under
    each environment) and colour targets of a constant material
    (albedo_rgb, metallic, roughness; drawn from ``seed`` when not given)
    at ``resolution``^2 for ``n_views`` fixed cameras, and write them to
    ``out_dir/data.npz`` (f16) in the layout ``ControlNetDataset`` reads."""
    import dreammat_tpu_torch.models  # noqa: F401  (registry)
    from dreammat_tpu_torch.data import cameras as cam_lib
    from dreammat_tpu_torch.data import prerender as prerender_lib

    device = resolve_device(device)
    find = dreammat_tpu_torch.find
    geo = find("dreammat-mesh")({"shape_init": f"mesh:{mesh_path}", "shape_init_params": 0.9},
                                device=device)
    mat = find("dreammat-material")(dict(material_cfg or {}), device=device)
    ren = find("raytracing-renderer")(dict(renderer_cfg or {}), geo, mat, device=device)
    cam = cam_lib.make_fixed_cameras(n_views, seed=seed)
    data = prerender_lib.prerender(ren, mat, cam, resolution, resolution, n_envs,
                                   cond_height=resolution, cond_width=resolution)

    if gt_material is None:
        rng = np.random.RandomState(seed)
        gt_material = (tuple(0.2 + 0.7 * rng.rand(3)), float(rng.rand()),
                       float(0.2 + 0.7 * rng.rand()))
    albedo_rgb, metal, rough = gt_material
    colors = np.zeros((n_views, n_envs, resolution, resolution, 3), dtype=np.float16)
    for i, gb in enumerate(data.gbuffers):
        P = gb.fg_pos.shape[0]
        alb = torch.tensor([albedo_rgb], dtype=torch.float32, device=device).expand(P, 3)
        met = torch.full((P, 1), float(metal), device=device)
        rgh = torch.full((P, 1), float(rough) ** 2, device=device)  # squared roughness
        valid = gb.fg_valid
        maskf = gb.mask.reshape(-1, 1).float()
        for e in range(n_envs):
            with torch.no_grad():
                out = mat.shade_raytracing(gb.fg_pos, gb.fg_normal, gb.fg_viewdir, e, met, rgh,
                                           alb, None, is_train=False, mask=valid)
            img = torch.ones(resolution * resolution, 3, device=device)
            img[gb.fg_idx[valid]] = out["color"][valid]
            img = img * maskf + (1 - maskf)  # white background
            colors[i, e] = img.reshape(resolution, resolution, 3).cpu().numpy().astype(np.float16)

    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "data.npz"), colors=colors,
        depths=data.depths.cpu().numpy(), normals=data.normals.cpu().numpy(),
        lightmaps=data.lightmaps.cpu().numpy())
    return out_dir
