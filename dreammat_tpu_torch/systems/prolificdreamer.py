"""ProlificDreamer system: text-to-3D by VSD, coarse, geometry and texture stages.

Counterpart of ``prolificdreamer-system`` in
``dreammat_tpu/systems/prolificdreamer.py``: the DreamFusion runtime with
the ``no-material`` (raw colour) and the VSD guidance. The loss is every
``loss_*`` the guidance returns weighted by its scheduled ``lambda_*``
(default 1), and by stage:

- ``coarse``: a NeRF volume, plus the orient, sparsity and opaque losses
  and the HiFA z-variance over pixels of opacity > 0.5 as a masked mean;
- ``geometry``: an ``implicit-volume`` geometry becomes
  ``tetrahedra-sdf-grid`` and the ``nerf-volume-renderer`` becomes
  ``nvdiff-rasterizer``; the rasterizer renders no colour and the guidance
  scores ``comp_normal``; plus ``normal_consistency`` and, when its lambda
  is set, ``laplacian_smoothness`` of the soup;
- ``texture``: the same types; the guidance scores ``comp_rgb`` with no
  other loss.

The strict config parse stays: a geometry or renderer block written for
the volume (``normal_type``, ``num_samples_per_ray``, ...) does not parse as
DMTet's or the rasterizer's, so a run of the refinement stages from
``configs/prolificdreamer.yaml`` replaces those blocks. One backward serves
both optimizers: the scene's and, over the guidance's LoRA state
(``init_lora`` at ``on_fit_start``), its own ``optimizer_lora``, stepped
after the scene's. Checkpoints hold both (``lora.*`` keys beside the
scene's).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion, as_image
from dreammat_tpu_torch.systems.magic3d import switch_to_dmtet
from dreammat_tpu_torch.systems.optimizers import parse_optimizer
from dreammat_tpu_torch.utils.ckpt import save_checkpoint
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("prolificdreamer-system")
class ProlificDreamer(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        stage: str = "coarse"
        material_type: str = "no-material"
        background_type: str = "neural-environment-map-background"
        guidance_type: str = "stable-diffusion-vsd-guidance"
        loss: dict = field(default_factory=lambda: {
            "lambda_vsd": 1.0, "lambda_lora": 1.0, "lambda_orient": 0.0,
            "lambda_sparsity": 10.0, "lambda_opaque": [10000, 0.0, 1000.0, 10001],
            "lambda_z_variance": 0.0})
        optimizer_lora: dict = field(default_factory=lambda: {
            "name": "AdamW", "args": {"lr": 1.0e-4, "betas": [0.9, 0.99], "eps": 1.0e-15}})

    cfg: Config

    def configure(self, device="cuda") -> None:
        if self.cfg.stage not in ("coarse", "geometry", "texture"):
            raise ValueError(f"Unknown stage {self.cfg.stage}")
        if self.cfg.stage != "coarse":
            switch_to_dmtet(self.cfg)
        super().configure(device)
        self.lora = None
        self.optimizer_lora = None
        self._pending_lora = None

    def on_fit_start(self, seed: int = 0) -> None:
        super().on_fit_start(seed)
        if self.lora is None and hasattr(self.guidance, "init_lora"):
            self.lora = self.guidance.init_lora(
                torch.Generator(device=self.device).manual_seed(seed + 0x70AA))
            self.optimizer_lora = parse_optimizer(self.cfg.optimizer_lora,
                                                  self.lora.parameters())
            if self._pending_lora is not None:
                sd, opt = self._pending_lora
                self.lora.load_state_dict(sd, strict=True)
                if opt is not None:
                    self.optimizer_lora.load_state_dict(opt)
                self._pending_lora = None

    def train_render_kw(self) -> Dict[str, Any]:
        return {"render_rgb": False} if self.cfg.stage == "geometry" else {}

    def guidance_input(self, out: Dict[str, torch.Tensor], batch: Dict[str, Any]):
        key = "comp_normal" if self.cfg.stage == "geometry" else "comp_rgb"
        return as_image(out[key], batch), {}

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        step = self.global_step
        loss_cfg = dict(self.cfg.loss)
        self.optimizer.zero_grad(set_to_none=True)
        if self.optimizer_lora is not None:
            self.optimizer_lora.zero_grad(set_to_none=True)
        stage = self.cfg.stage
        out = self.render_batch(batch, draws, is_train=True, **self.train_render_kw())
        args = (self.guidance_input(out, batch)[0], self.prompt_utils, batch["elevation"], batch["azimuth"],
                batch["camera_distances"])
        if self.lora is not None:
            g = self.guidance(*args, c2w=batch["c2w"], lora=self.lora, step=step, draws=draws)
        else:
            g = self.guidance(*args, None, step=step, draws=draws)
        loss, metrics = 0.0, {}
        for name, value in g.items():
            if name.startswith("loss_"):
                loss = loss + C(loss_cfg.get("lambda_" + name[5:], 1.0), step) * value
                metrics[name] = value
        if stage == "coarse":
            reg, reg_metrics = self.regularizers(out, step)
            metrics.update(reg_metrics)
            m = (out["opacity"] > 0.5).float()
            metrics["loss_z_variance"] = torch.sum(out["z_variance"] * m) / torch.clamp(
                m.sum(), min=1.0)
            loss = loss + reg + C(loss_cfg.get("lambda_z_variance", 0.0), step) \
                * metrics["loss_z_variance"]
        elif stage == "geometry":
            reg, reg_metrics = self.mesh_regularizers(out, step, laplacian=True)
            metrics.update(reg_metrics)
            loss = loss + reg
        loss.backward()
        self.optimizer.step()
        if self.optimizer_lora is not None:
            self.optimizer_lora.step()
        self.global_step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                "grad_norm": g["grad_norm"].detach(), "min_step": g["min_step"],
                "max_step": g["max_step"]}

    # -- checkpoints --------------------------------------------------------
    def save_checkpoint(self, trial_dir: str, step: int) -> str:
        sd = dict(self.field.state_dict())
        opt = {"scene": self.optimizer.state_dict()}
        if self.lora is not None:
            sd.update({"lora." + k: v for k, v in self.lora.state_dict().items()})
            opt["lora"] = self.optimizer_lora.state_dict()
        return save_checkpoint(os.path.join(trial_dir, "ckpts", f"step{step:06d}"), sd, opt,
                               step)

    def load_state(self, state_dict, optimizer_state=None, step: int = 0) -> None:
        """The scene, the LoRA state (loaded now, or when ``on_fit_start``
        builds it) and both optimizers from a checkpoint."""
        lora_sd = {k[5:]: v for k, v in state_dict.items() if k.startswith("lora.")}
        scene_sd = {k: v for k, v in state_dict.items() if not k.startswith("lora.")}
        opt = optimizer_state or {}
        super().load_state(scene_sd, opt.get("scene"), step)
        if lora_sd:
            if self.lora is not None:
                self.lora.load_state_dict(lora_sd, strict=True)
                if opt.get("lora") is not None:
                    self.optimizer_lora.load_state_dict(opt["lora"])
            else:
                self._pending_lora = (lora_sd, opt.get("lora"))
