"""Score Jacobian Chaining system over a 4-channel latent NeRF volume.

Counterpart of ``sjc-system`` in ``dreammat_tpu/systems/sjc.py``: the
Latent-NeRF runtime with the guidance's SJC estimator forced on
(``use_sjc``) and the rendered image always taken as latents. The loss is
SJC's plus, each weighted by its scheduled ``lambda_*``:

    emptiness = mean(log(1 + k w)),  k = ``emptiness_scale``, w the weights
    depth     = sign(x) log(|x| + 1e-12) lambda_depth,
                x = mean(centre) - mean(border) + 1e-12

over the depth composited against a background 10 units away, D + 10 (1 -
opacity), as an H x W image whose centre is the ``center_ratio`` crop
(static slices). The JAX package takes log|x| where the reference takes
log(x), which is NaN for x < 0; the port follows the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreamfusion import as_image
from dreammat_tpu_torch.systems.latentnerf import LatentNeRF
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("sjc-system")
class ScoreJacobianChaining(LatentNeRF):
    @dataclass
    class Config(LatentNeRF.Config):
        guidance_type: str = "stable-diffusion-guidance"
        subpixel_rendering: bool = False
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 1.0, "lambda_emptiness": [15000, 10000.0, 200000.0, 15001],
            "emptiness_scale": 10.0, "lambda_depth": 0.0, "center_ratio": 0.78125})

    cfg: Config

    def configure(self, device="cuda") -> None:
        g = dict(self.cfg.guidance)
        g.setdefault("use_sjc", True)
        self.cfg.guidance = g
        super().configure(device)

    def guidance_input(self, out: Dict[str, torch.Tensor], batch: Dict[str, Any]):
        return as_image(out["comp_rgb"], batch), {"rgb_as_latents": True}

    def regularizers(self, out: Dict[str, torch.Tensor], step: int,
                     batch: Optional[Dict[str, Any]] = None):
        """(weighted sum, metrics) of the emptiness and centre-depth terms."""
        loss_cfg = dict(self.cfg.loss)
        metrics = {"loss_emptiness": torch.log1p(
            loss_cfg.get("emptiness_scale", 10.0) * out["weights"]).mean()}
        loss = C(loss_cfg.get("lambda_emptiness", 0.0), step) * metrics["loss_emptiness"]
        h, w = batch["height"], batch["width"]
        depth = (out["depth"] + 10.0 * (1.0 - out["opacity"])).reshape(h, w)
        cr = float(loss_cfg.get("center_ratio", 0.78125))
        ch, cw = int(cr * h), int(cr * w)
        bh, bw = (h - ch) // 2, (w - cw) // 2
        center = depth[bh:bh + ch, bw:bw + cw]
        border_mean = (depth.sum() - center.sum()) / max(h * w - ch * cw, 1)
        x = center.mean() - border_mean + 1e-12
        metrics["loss_depth"] = (torch.sign(x) * torch.log(x.abs() + 1e-12)
                                 * C(loss_cfg.get("lambda_depth", 0.0), step))
        return loss + metrics["loss_depth"], metrics
