"""TexCraft system: texture generation with a guidance chosen by the config.

Counterpart of ``dreammat_tpu/systems/texcraft.py``. The DreamMat system's
runtime (fit, validation, test renders, export, checkpoints, optimizers)
with its own train step: the guidance type comes from the config
(``stable-diffusion-guidance`` by default), its conditions are the live
render's depth and normal (``cat(comp_depth, comp_normal)``, detached)
instead of the prerendered light-probe stack, and the loss is
``lambda_mat_reg * loss_mat_reg`` plus every ``loss_*`` the guidance
returns, each weighted by its scheduled ``lambda_*`` (default 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreammat import DreamMat
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("texcraft-system")
class TexCraft(DreamMat):
    @dataclass
    class Config(DreamMat.Config):
        guidance_type: str = "stable-diffusion-guidance"
        render_depth: bool = True

    cfg: Config

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        step = self.global_step
        loss_cfg = dict(self.cfg.loss)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.renderer.shade_view(
            self.field, batch["gbuffer"], batch["env_id"], draws,
            light_table=batch.get("light_table"), jitter_pts=batch.get("jitter_pts"),
            pixel_vis=batch.get("pixel_vis"),
        )
        # live conditions of this render: channel 0 depth, 1:4 normal
        live = torch.cat([out["comp_depth"], out["comp_normal"]], dim=-1)
        g = self.guidance(
            torch.clamp(out["comp_rgb"], 0.0, 1.0).permute(2, 0, 1)[None], self.prompt_utils,
            batch["elevation"], batch["azimuth"], batch["camera_distances"],
            live.permute(2, 0, 1)[None].detach(), step=step, draws=draws,
        )
        loss = C(loss_cfg.get("lambda_mat_reg", 0.0), step) * out["loss_mat_reg"]
        metrics = {"loss_mat_reg": out["loss_mat_reg"].detach()}
        for name, value in g.items():
            if name.startswith("loss_"):
                loss = loss + C(loss_cfg.get(name.replace("loss_", "lambda_"), 1.0), step) * value
                metrics[name] = value.detach()
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss.detach(), **metrics, "grad_norm": g["grad_norm"].detach(),
                "min_step": g["min_step"], "max_step": g["max_step"]}
