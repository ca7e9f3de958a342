"""DreamMat system: renderer + guidance composed into one eager train step.

Counterpart of ``dreammat_tpu/systems/dreammat.py`` (``configure``,
``on_fit_start``, ``init_state``, ``make_train_step``, ``fit``). The train
step is: field query -> prefiltered shade -> VAE encode (differentiated) ->
3x (ControlNet + UNet) under no_grad -> CSD loss -> ``backward`` ->
``Adam.step``. ``fit`` logs to the console and to ``<trial_dir>/logs/
metrics.csv``. Validation, test renders, checkpoints, TensorBoard / wandb,
the train grid and export are later slices.
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.optimizers import parse_optimizer
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.rng import TorchDraws
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("dreammat-system")
class DreamMat(BaseObject):
    @dataclass
    class Config:
        texture: bool = True
        latent_steps: int = 1000
        save_train_image: bool = True
        save_train_image_iter: int = 1000
        init_step: int = 0
        init_width: int = 512
        init_height: int = 512
        test_background_white: bool = False
        geometry_type: str = "dreammat-mesh"
        geometry: dict = field(default_factory=dict)
        material_type: str = "dreammat-material"
        material: dict = field(default_factory=dict)
        background_type: str = "solid-color-background"
        background: dict = field(default_factory=dict)
        renderer_type: str = "raytracing-renderer"
        renderer: dict = field(default_factory=dict)
        guidance_type: str = "stable-diffusion-dreammat-guidance"
        guidance: dict = field(default_factory=dict)
        prompt_processor_type: str = "stable-diffusion-prompt-processor"
        prompt_processor: dict = field(default_factory=dict)
        exporter: dict = field(default_factory=dict)
        loss: dict = field(default_factory=lambda: {"lambda_sds": 1.0, "lambda_mat_reg": 1.0})
        optimizer: dict = field(default_factory=lambda: {
            "name": "Adam", "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1.0e-15}})
        loggers: dict = field(default_factory=dict)
        seed: int = 0

    cfg: Config

    def configure(self, device="cuda") -> None:
        """Geometry, material and renderer (the background is a config key
        only: the shade composites over white, as the JAX renderer does)."""
        import dreammat_tpu_torch.models  # noqa: F401  (registry)

        self.device = resolve_device(device)
        find = dreammat_tpu_torch.find
        self.geometry = find(self.cfg.geometry_type)(self.cfg.geometry, device=self.device)
        self.material = find(self.cfg.material_type)(self.cfg.material, device=self.device)
        self.renderer = find(self.cfg.renderer_type)(
            self.cfg.renderer, self.geometry, self.material, device=self.device)
        self.guidance = None
        self.prompt_processor = None
        self.prompt_utils = None
        self.field = None
        self.optimizer = None
        self.global_step = 0
        self.step_seconds: List[float] = []

    def on_fit_start(self, seed: int = 0) -> None:
        """Build the guidance (random weights) and the prompt embeddings."""
        find = dreammat_tpu_torch.find
        if self.guidance is None:
            self.guidance = find(self.cfg.guidance_type)(self.cfg.guidance, device=self.device)
            self.guidance.init_params(torch.Generator(device=self.device).manual_seed(seed + 1))
        if self.prompt_processor is None:
            self.prompt_processor = find(self.cfg.prompt_processor_type)(
                self.cfg.prompt_processor, device=self.device)
        if self.prompt_utils is None:
            self.prompt_utils = self.prompt_processor()

    def init_state(self, seed: int = 0) -> None:
        """A fresh material field and its optimizer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.field = self.geometry.init(gen)
        self.optimizer = parse_optimizer(self.cfg.optimizer, self.field.parameters())
        self.global_step = 0

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        """One optimization step on ``batch``; every random draw comes from
        ``draws`` (see utils/rng.py)."""
        step = self.global_step
        loss_cfg = dict(self.cfg.loss)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.renderer.shade_view(
            self.field, batch["gbuffer"], batch["env_id"], draws,
            light_table=batch.get("light_table"), jitter_pts=batch.get("jitter_pts"),
        )
        g = self.guidance(
            out["comp_rgb"].permute(2, 0, 1)[None], self.prompt_utils,
            batch["elevation"], batch["azimuth"], batch["camera_distances"],
            batch["condition_map"], step=step, draws=draws,
        )
        loss = (C(loss_cfg.get("lambda_sds", 1.0), step) * g["loss_sds"]
                + C(loss_cfg.get("lambda_mat_reg", 1.0), step) * out["loss_mat_reg"])
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {
            "loss": loss.detach(),
            "loss_sds": g["loss_sds"].detach(),
            "loss_mat_reg": out["loss_mat_reg"].detach(),
            "grad_norm": g["grad_norm"].detach(),
            "min_step": g["min_step"],
            "max_step": g["max_step"],
        }

    def fit(self, datamodule, max_steps: int, seed: int = 0,
            trial_dir: str = "outputs/dreammat_torch", log_every: int = 10,
            draws=None) -> Dict[str, Any]:
        """The training loop. Returns {"field": MaterialField, "step": int}."""
        self.on_fit_start(seed)
        if self.field is None:
            self.init_state(seed)
        elif self.optimizer is None:
            self.optimizer = parse_optimizer(self.cfg.optimizer, self.field.parameters())
        if draws is None:
            draws = TorchDraws(seed + 2, self.device)
        log_dir = os.path.join(trial_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        # one file per fit: rows of an earlier run into the same trial_dir go
        with open(os.path.join(log_dir, "metrics.csv"), "w", newline="") as fcsv:
            writer = None
            for it in range(self.global_step, max_steps):
                batch = datamodule.collate(step=it)
                draws.step = it
                t0 = time.time()
                metrics = self.train_step(batch, draws)
                sync()
                self.step_seconds.append(time.time() - t0)
                if (it + 1) % log_every == 0 or it + 1 == max_steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    dreammat_tpu_torch.info(
                        "step %d loss=%.4f sds=%.4f reg=%.5f (%.3f s/step)", it + 1, m["loss"],
                        m["loss_sds"], m["loss_mat_reg"], self.step_seconds[-1])
                    row = {"step": it + 1, **m, "seconds": self.step_seconds[-1]}
                    if writer is None:
                        writer = csv.DictWriter(fcsv, fieldnames=list(row))
                        writer.writeheader()
                    writer.writerow(row)
        return {"field": self.field, "step": self.global_step}
