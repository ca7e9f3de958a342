"""Instruct-NeRF2NeRF: text-instructed editing of a captured NeRF.

Counterpart of ``instructnerf2nerf-system`` in
``dreammat_tpu/systems/instructnerf2nerf.py``, on the port's DreamFusion
(the volume scene, ``fit``, the occupancy refresh, the evaluation).
Training is the iterative dataset update: the batch is one frame of a
multiview capture; after ``start_editing_step``, a frame without an edit,
and every frame on every ``per_editing_step``-th step, is rendered in
evaluation mode from the current field and pushed through the
InstructPix2Pix editor, conditioned on the frame's original image and the
instruction (draws under ``edit/``); the edit replaces the frame's target
in ``edit_frames``, a host-side dict of device tensors keyed by frame
index. The field then fits its target with

    loss = lambda_l1 |render - target|_1 + lambda_p perceptual(render, target)
           + the orient, sparsity and opaque terms of DreamFusion

(``utils/perceptual.py``'s VGG16 tower, from ``vgg_cache_dir`` where that
holds torchvision weights). ``edit_seconds`` keeps each edit's seconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.volume_renderer import PrefixedDraws
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion
from dreammat_tpu_torch.utils import perceptual
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("instructnerf2nerf-system")
class InstructNeRF2NeRF(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        guidance_type: str = "stable-diffusion-instructpix2pix-guidance"
        per_editing_step: int = 10
        start_editing_step: int = 1000
        vgg_cache_dir: str = "model/vgg16"
        loss: dict = field(default_factory=lambda: {
            "lambda_l1": 10.0, "lambda_p": 10.0, "lambda_orient": 0.0,
            "lambda_sparsity": 0.0, "lambda_opaque": 0.0})

    cfg: Config

    def configure(self, device="cuda") -> None:
        super().configure(device)
        self.edit_frames: Dict[int, torch.Tensor] = {}
        self.edit_seconds: List[float] = []
        self.vgg = perceptual.init_vgg16(torch.Generator(device=self.device).manual_seed(0),
                                         self.cfg.vgg_cache_dir, device=self.device)

    def wants_edit(self, idx: int, it: int) -> bool:
        """Whether step ``it`` refreshes frame ``idx``'s edit."""
        cfg = self.cfg
        if cfg.per_editing_step <= 0 or it <= cfg.start_editing_step:
            return False
        return idx not in self.edit_frames or it % cfg.per_editing_step == 0

    def edit_render(self, batch: Dict[str, Any], draws) -> torch.Tensor:
        """The current field's evaluation render of the batch's frame [1,H,W,3]
        (at step 0, as the JAX package renders it)."""
        f = self.field
        out = self.renderer.render_rays(f.geo, f.bg, f.occ, batch["rays_o"], batch["rays_d"],
                                        batch["light_positions"], draws, step=0, is_train=False)
        return out["comp_rgb"].reshape(1, batch["height"], batch["width"], 3)

    @torch.no_grad()
    def maybe_edit(self, batch: Dict[str, Any], it: int, draws) -> None:
        """Refresh the batch frame's target when ``wants_edit``."""
        idx = int(batch["index"])
        if not self.wants_edit(idx, it):
            return
        t0 = time.time()
        edit_draws = PrefixedDraws(draws, "edit/")
        rgb = self.edit_render(batch, edit_draws)
        res = self.guidance(rgb, batch["gt_rgb"][None], self.prompt_utils, step=0,
                            draws=edit_draws)
        self.edit_frames[idx] = res["edit_images"][0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.edit_seconds.append(time.time() - t0)

    def target(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The frame's edit where it has one, else its captured image [H,W,3]."""
        return self.edit_frames.get(int(batch["index"]), batch["gt_rgb"])

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        step = self.global_step
        self.maybe_edit(batch, step, draws)
        H, W = batch["height"], batch["width"]
        loss_cfg = dict(self.cfg.loss)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.render_batch(batch, draws, is_train=True)
        pred = out["comp_rgb"].reshape(1, H, W, 3)
        gt = self.target(batch).reshape(1, H, W, 3)
        loss_l1 = torch.mean(torch.abs(pred - gt))
        loss_p = perceptual.perceptual_distance(self.vgg, pred, gt)
        reg, metrics = self.regularizers(out, step)
        loss = (C(loss_cfg.get("lambda_l1", 0.0), step) * loss_l1
                + C(loss_cfg.get("lambda_p", 0.0), step) * loss_p + reg)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        zero = torch.zeros((), device=self.device)
        return {"loss": loss.detach(), "loss_l1": loss_l1.detach(), "loss_p": loss_p.detach(),
                **{k: v.detach() for k, v in metrics.items()},
                "grad_norm": zero, "min_step": 0, "max_step": 0}
