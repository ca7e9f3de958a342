"""DreamFusion system: text-to-3D by SDS over a NeRF volume.

Counterpart of ``dreamfusion-system`` in ``dreammat_tpu/systems/dreamfusion.py``
on the port's DreamMat runtime (``fit``, the loggers, checkpoints): an
implicit-volume geometry, the diffuse point-light material, a neural
environment-map background and the NeRF volume renderer, trained by SDS
with the orient, sparsity and opaque regularizers, each weighted by its
scheduled ``lambda_*``:

    orient   = sum(stopgrad(w) relu(n . d)^2) / max(#(opacity > 0), 1)
    sparsity = mean(sqrt(opacity^2 + 0.01))
    opaque   = BCE(o, o), o = clamp(opacity, 1e-3, 1 - 1e-3)

The trainable state is a ``VolumeScene`` (the geometry's field, the
background's and the occupancy grid as a buffer), so checkpoints carry the
grid. ``init_state`` runs the first occupancy refresh; the
``on_train_batch_start`` hook refreshes it every
``renderer.grid_update_every`` steps (``occ_jitter`` draws). Evaluation
renders through ``render_image`` in chunks; ``export`` writes the density
isosurface as an OBJ with per-vertex albedo colours.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import dmtet
from dreammat_tpu_torch.systems.dreammat import DreamMat
from dreammat_tpu_torch.systems.optimizers import parse_optimizer
from dreammat_tpu_torch.utils import saving
from dreammat_tpu_torch.utils.rng import TorchDraws
from dreammat_tpu_torch.utils.schedule import C


def binary_cross_entropy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -(y * torch.log(x) + (1 - y) * torch.log(1 - x)).mean()


def orient_loss(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The orient term of a volume render's outputs (the module docstring's)."""
    ndv = torch.sum(out["normal"] * out["t_dirs"], dim=-1)
    n_fg = torch.clamp((out["opacity"] > 0).sum(), min=1)
    return torch.sum(out["weights"].detach() * torch.clamp(ndv, min=0.0) ** 2) / n_fg


def as_image(x: torch.Tensor, batch: Dict[str, Any]) -> torch.Tensor:
    """Per-ray values [H*W, C] of a training batch -> an image [1, C, H, W]."""
    return x.reshape(1, batch["height"], batch["width"], -1).permute(0, 3, 1, 2)


class VolumeScene(nn.Module):
    """A volume system's state: ``geo`` (the geometry's field), ``bg`` (the
    background's) and the occupancy grid ``occ`` [G,G,G] (a buffer; None
    under the mesh rasterizer, which has no grid)."""

    def __init__(self, geo: nn.Module, bg: nn.Module, occ: Optional[torch.Tensor]):
        super().__init__()
        self.geo = geo
        self.bg = bg
        self.register_buffer("occ", occ)


@dreammat_tpu_torch.register("dreamfusion-system")
class DreamFusion(DreamMat):
    @dataclass
    class Config(DreamMat.Config):
        geometry_type: str = "implicit-volume"
        material_type: str = "diffuse-with-point-light-material"
        background_type: str = "neural-environment-map-background"
        renderer_type: str = "nerf-volume-renderer"
        guidance_type: str = "stable-diffusion-guidance"
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 1.0, "lambda_orient": [0, 10.0, 1000.0, 5000],
            "lambda_sparsity": 1.0, "lambda_opaque": 0.0})

    cfg: Config

    def _make_renderer(self):
        find = dreammat_tpu_torch.find
        self.background = find(self.cfg.background_type)(self.cfg.background, device=self.device)
        return find(self.cfg.renderer_type)(self.cfg.renderer, self.geometry, self.material,
                                            self.background, device=self.device)

    def init_state(self, seed: int = 0) -> None:
        """A fresh scene (field, background, the grid after its first
        refresh) and its optimizer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        geo = self.geometry.init(gen)
        bg = self.background.init(gen)
        occ = self.renderer.update_occ(geo, self.renderer.init_state(),
                                       TorchDraws(seed + 3, self.device))
        self.field = VolumeScene(geo, bg, occ)
        self.optimizer = parse_optimizer(self.cfg.optimizer, self.field.parameters())
        self.global_step = 0

    def on_train_batch_start(self, it: int, draws) -> None:
        r = self.renderer.cfg
        if r.estimator == "occgrid" and r.grid_prune and it % max(r.grid_update_every, 1) == 0:
            self.field.occ.copy_(self.renderer.update_occ(self.field.geo, self.field.occ, draws))

    def step_kind(self, batch: Dict[str, Any]) -> str:
        return "volume"

    def render_batch(self, batch: Dict[str, Any], draws, is_train: bool, **kw):
        """The batch's rays through the renderer (``kw``: the rasterizer's
        ``render_rgb``)."""
        f = self.field
        return self.renderer.render_rays(f.geo, f.bg, f.occ, batch["rays_o"], batch["rays_d"],
                                         batch["light_positions"], draws,
                                         step=self.global_step, is_train=is_train, **kw)

    def regularizers(self, out: Dict[str, torch.Tensor], step: int,
                     batch: Optional[Dict[str, Any]] = None):
        """(weighted sum, metrics) of the orient, sparsity and opaque losses
        (``batch``: the training batch, for losses over the image)."""
        loss_cfg = dict(self.cfg.loss)
        loss, metrics = 0.0, {}
        if "normal" in out:
            metrics["loss_orient"] = orient_loss(out)
            loss = loss + C(loss_cfg.get("lambda_orient", 0.0), step) * metrics["loss_orient"]
        metrics["loss_sparsity"] = torch.sqrt(out["opacity"] ** 2 + 0.01).mean()
        loss = loss + C(loss_cfg.get("lambda_sparsity", 0.0), step) * metrics["loss_sparsity"]
        oc = torch.clamp(out["opacity"], 1e-3, 1.0 - 1e-3)
        metrics["loss_opaque"] = binary_cross_entropy(oc, oc)
        loss = loss + C(loss_cfg.get("lambda_opaque", 0.0), step) * metrics["loss_opaque"]
        return loss, metrics

    def mesh_regularizers(self, out: Dict[str, torch.Tensor], step: int,
                          laplacian: bool = False):
        """(weighted sum, metrics) of a DMTet stage's losses over the render's
        soup: ``normal_consistency`` (on the vertex normals the render
        computed) and, with ``laplacian`` and its lambda set,
        ``laplacian_smoothness``."""
        loss_cfg = dict(self.cfg.loss)
        metrics = {"loss_normal_consistency": dmtet.normal_consistency(
            *out["mesh"], vn=out["vertex_normals"])}
        loss = C(loss_cfg.get("lambda_normal_consistency", 0.0), step) \
            * metrics["loss_normal_consistency"]
        lam_lap = loss_cfg.get("lambda_laplacian_smoothness", 0.0)
        if laplacian and lam_lap:
            metrics["loss_laplacian_smoothness"] = dmtet.laplacian_smoothness(*out["mesh"])
            loss = loss + C(lam_lap, step) * metrics["loss_laplacian_smoothness"]
        return loss, metrics

    def train_render_kw(self) -> Dict[str, Any]:
        """The renderer's keyword arguments in a training step."""
        return {}

    def guidance_input(self, out: Dict[str, torch.Tensor], batch: Dict[str, Any]):
        """(image [1,C,H,W], guidance keyword arguments) of a training render."""
        return as_image(out["comp_rgb"], batch), {}

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        """Render, SDS on ``guidance_input``, plus ``regularizers``; one
        backward and one optimizer step."""
        step = self.global_step
        self.optimizer.zero_grad(set_to_none=True)
        out = self.render_batch(batch, draws, is_train=True, **self.train_render_kw())
        img, kw = self.guidance_input(out, batch)
        g = self.guidance(img, self.prompt_utils, batch["elevation"], batch["azimuth"],
                          batch["camera_distances"], None, step=step, draws=draws, **kw)
        reg, metrics = self.regularizers(out, step, batch)
        loss = C(dict(self.cfg.loss).get("lambda_sds", 1.0), step) * g["loss_sds"] + reg
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss.detach(), "loss_sds": g["loss_sds"].detach(),
                **{k: v.detach() for k, v in metrics.items()},
                "grad_norm": g["grad_norm"].detach(), "min_step": g["min_step"],
                "max_step": g["max_step"]}

    # -- evaluation ---------------------------------------------------------
    def eval_out(self, batch: Dict[str, Any], step: int) -> Dict[str, torch.Tensor]:
        f = self.field
        return self.renderer.render_image(f.geo, f.bg, f.occ, batch["rays_o"], batch["rays_d"],
                                          batch["light_position"], TorchDraws(0, self.device),
                                          step=step)

    def save_train_grid(self, batch, trial_dir: str, step: int) -> str:
        h, w = batch["height"], batch["width"]
        with torch.no_grad():
            out = self.render_batch(batch, TorchDraws(step, self.device), is_train=False)
        img = lambda k, c: out[k].reshape(h, w, c).cpu().numpy()
        row = [{"img": img("comp_rgb", 3)}, {"img": img("opacity", 1)[..., 0]},
               {"img": img("depth", 1)[..., 0]}]
        if "comp_normal" in out:
            row.append({"img": img("comp_normal", 3)})
        return saving.save_image_grid(os.path.join(trial_dir, "save", f"it{step}-train.png"),
                                      [row])

    def validation(self, datamodule, trial_dir: str, step: int) -> str:
        out = {k: v.cpu().numpy() for k, v in self.eval_out(datamodule.eval_rays(0), step).items()}
        row = [{"img": out["comp_rgb"]}, {"img": out["opacity"][..., 0]}]
        if "comp_normal" in out:
            row.insert(1, {"img": out["comp_normal"]})
        return saving.save_image_grid(os.path.join(trial_dir, "save", f"it{step}-val.png"), [row])

    def test(self, datamodule, trial_dir: str, step: int, n_views: Optional[int] = None) -> str:
        """The eval circle: ``save/it{step}-test/{i}.png`` per view and the gif."""
        n = n_views or datamodule.cfg.n_test_views
        d = os.path.join(trial_dir, "save", f"it{step}-test")
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        frames, self.test_seconds = [], []
        for i in range(n):
            t0 = time.time()
            rgb = self.eval_out(datamodule.eval_rays(i), step)["comp_rgb"]
            sync()
            self.test_seconds.append(time.time() - t0)
            rgb = rgb.cpu().numpy()
            saving.save_image(os.path.join(d, f"{i}.png"), rgb)
            frames.append(rgb)
        return saving.save_gif(os.path.join(trial_dir, "save", f"it{step}-test.gif"), frames,
                               fps=30)

    @torch.no_grad()
    def export(self, trial_dir: str, texture_size: Optional[int] = None) -> str:
        """``save/export/model.obj``: the density isosurface with per-vertex
        albedo as vertex colours (``v x y z r g b``)."""
        verts, faces = self.geometry.isosurface_mesh(self.field.geo)
        d = os.path.join(trial_dir, "save", "export")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "model.obj")
        if len(verts):
            feat = self.geometry.export(self.field.geo,
                                        torch.from_numpy(verts).to(self.device)).get("features")
            albedo = (self.material.export(feat)["albedo"].cpu().numpy() if feat is not None
                      else np.full_like(verts, 0.5))
        else:
            albedo = np.zeros((0, 3), np.float32)
        with open(path, "w") as f:
            for v, c in zip(verts, albedo):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            for tri in faces + 1:
                f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
        dreammat_tpu_torch.info("exported isosurface: %d verts, %d faces -> %s", len(verts),
                                len(faces), path)
        return path
