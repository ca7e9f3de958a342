"""Magic123 system: single image to 3D under a 2D and a 3D prior at once.

Counterpart of ``magic123-system`` in ``dreammat_tpu/systems/magic123.py``
on the port's DreamFusion runtime. Every step renders the reference view
and a random view in one render call (``render_ref_and_random`` of
``systems/zero123.py``) and takes

- the reference view's colour MSE (against the image composited over the
  render's background) and the mask's binary cross-entropy (opacity
  clamped to [1e-5, 1 - 1e-5]);
- on the random view, both guidances on the same image, back to back: the
  prompted SD SDS (``guidance``, weight ``lambda_sds``) and Zero123's SDS
  (``guidance_3d``, weight ``lambda_3d_sds``; its draws are named with the
  prefix ``guidance_3d/``);
- in the volume stage the orient term and, with its lambda set, the 2D
  normal smoothness; with ``refinement`` (an ``implicit-volume`` becomes
  ``tetrahedra-sdf-grid`` and the volume renderer ``nvdiff-rasterizer``) the
  mesh's normal consistency and, with its lambda set, the uniform-Laplacian
  smoothness (``ops/dmtet.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.volume_renderer import PrefixedDraws
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion, as_image, orient_loss
from dreammat_tpu_torch.systems.magic3d import switch_to_dmtet
from dreammat_tpu_torch.systems.zero123 import normal_smoothness_2d, render_ref_and_random
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("magic123-system")
class Magic123(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        guidance_type: str = "stable-diffusion-guidance"
        guidance_3d_type: str = "zero123-guidance"
        guidance_3d: dict = field(default_factory=dict)
        refinement: bool = False
        freq: dict = field(default_factory=dict)  # accepted
        ambient_ratio_min: float = 0.5
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 0.025, "lambda_3d_sds": 1.0, "lambda_rgb": 1000.0,
            "lambda_mask": 100.0, "lambda_orient": 0.0, "lambda_normal_smoothness_2d": 0.0,
            "lambda_normal_consistency": 1000.0, "lambda_laplacian_smoothness": 0.0})

    cfg: Config

    def configure(self, device="cuda") -> None:
        if self.cfg.refinement:
            switch_to_dmtet(self.cfg)
        super().configure(device)
        self.guidance_3d = None

    def on_fit_start(self, seed: int = 0) -> None:
        """The SD guidance and the prompts, then the Zero123 guidance."""
        super().on_fit_start(seed)
        if self.guidance_3d is None:
            self.guidance_3d = dreammat_tpu_torch.find(self.cfg.guidance_3d_type)(
                self.cfg.guidance_3d, device=self.device)
            self.guidance_3d.init_params(torch.Generator(device=self.device).manual_seed(seed + 5))

    def train_render_kw(self) -> Dict[str, Any]:
        return {"render_rgb": True} if self.cfg.refinement else {}

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        step = self.global_step
        lc = dict(self.cfg.loss)
        rc = batch["random_camera"]
        self.optimizer.zero_grad(set_to_none=True)
        out_r, out = render_ref_and_random(self, batch, draws)
        m = batch["mask"].reshape(-1)
        gt = batch["rgb"].reshape(-1, 3) * m[:, None] + out_r["comp_rgb_bg"] * (1.0 - m[:, None])
        op = torch.clamp(out_r["opacity"][:, 0], 1e-5, 1.0 - 1e-5)
        metrics = {"loss_rgb": torch.mean((out_r["comp_rgb"] - gt) ** 2),
                   "loss_mask": -torch.mean(m * torch.log(op) + (1.0 - m) * torch.log(1.0 - op))}
        loss = C(lc.get("lambda_rgb", 0.0), step) * metrics["loss_rgb"] \
            + C(lc.get("lambda_mask", 0.0), step) * metrics["loss_mask"]

        img = as_image(out["comp_rgb"], rc)
        view = (rc["elevation"], rc["azimuth"], rc["camera_distances"])
        g2 = self.guidance(img, self.prompt_utils, *view, None, step=step, draws=draws)
        g3 = self.guidance_3d(img, *view, step=step, draws=PrefixedDraws(draws, "guidance_3d/"))
        metrics["loss_sds"], metrics["loss_3d_sds"] = g2["loss_sds"], g3["loss_sds"]
        loss = loss + C(lc.get("lambda_sds", 0.0), step) * g2["loss_sds"] \
            + C(lc.get("lambda_3d_sds", 0.0), step) * g3["loss_sds"]

        if self.cfg.refinement:
            reg, mesh_metrics = self.mesh_regularizers(out, step, laplacian=True)
            loss = loss + reg
            metrics.update(mesh_metrics)
        else:
            if "normal" in out and "weights" in out:
                metrics["loss_orient"] = orient_loss(out)
                loss = loss + C(lc.get("lambda_orient", 0.0), step) * metrics["loss_orient"]
            lam = lc.get("lambda_normal_smoothness_2d", 0.0)
            if "comp_normal" in out and lam:
                metrics["loss_normal_smoothness_2d"] = normal_smoothness_2d(
                    out["comp_normal"], rc["height"], rc["width"])
                loss = loss + C(lam, step) * metrics["loss_normal_smoothness_2d"]
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                "grad_norm": g2["grad_norm"].detach(), "min_step": g2["min_step"],
                "max_step": g2["max_step"]}
