"""DreamMat system: renderer + guidance composed into one eager train step.

Counterpart of ``dreammat_tpu/systems/dreammat.py`` (``configure``,
``on_fit_start``, ``init_state``, ``make_train_step``, ``fit``,
``save_train_grid``, ``validation``, ``test``, ``export``). The train step
is: field query -> shade (the prefiltered tables, or the MC estimator when
the batch has no table) -> VAE encode (differentiated) -> 3x (ControlNet +
UNet; 5x with Perp-Neg) under no_grad -> CSD loss -> ``backward`` -> the
optimizer's step (``systems/optimizers.py``). ``fit`` logs to the console,
to ``<trial_dir>/logs/metrics.csv`` (one file per fit), to
``logs/events.tsv``, to a TensorBoard event file under ``tb/`` and to
wandb when ``loggers.wandb.enable`` is set and the package is installed,
and writes the progress file ``progress``; it saves the train grid every
``save_train_image_iter`` steps, a validation grid every
``val_check_interval`` and a checkpoint (``utils/ckpt.py``) every
``checkpoint_every``. ``test`` renders the eval circle to PNGs and a gif;
``export`` writes the textured OBJ/MTL.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.optimizers import parse_optimizer
from dreammat_tpu_torch.utils import saving
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.ckpt import save_checkpoint
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.loggers import (
    CSVLogger, MultiLogger, ProgressWriter, TSVEventLogger, WandbLogger,
)
from dreammat_tpu_torch.utils.rng import TorchDraws
from dreammat_tpu_torch.utils.tboard import TensorBoardLogger
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
        self.renderer = self._make_renderer()
        self.guidance = None
        self.prompt_processor = None
        self.prompt_utils = None
        self.field = None
        self.optimizer = None
        self.global_step = 0
        self.step_seconds: List[float] = []
        self.step_losses: List[float] = []
        self.step_kinds: List[str] = []      # "tables" or "mc", per fit step
        self.step_peak_gb: List[float] = []  # peak device memory per step (CUDA)
        self.test_seconds: List[float] = []  # per eval view of the last test()
        self.exporter = None

    def _make_renderer(self):
        return dreammat_tpu_torch.find(self.cfg.renderer_type)(
            self.cfg.renderer, self.geometry, self.material, device=self.device)

    def on_fit_start(self, seed: int = 0) -> None:
        """Build the guidance (weights from its cache_dir where present, random
        otherwise) and the prompt embeddings."""
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

    def load_state(self, state_dict, optimizer_state=None, step: int = 0) -> None:
        """The field, its optimizer and the step from a checkpoint."""
        if self.field is None:
            self.init_state()
        self.field.load_state_dict(state_dict, strict=True)
        if optimizer_state is not None:
            self.optimizer.load_state_dict(optimizer_state)
        self.global_step = int(step)

    def on_train_batch_start(self, it: int, draws) -> None:
        """A hook before step ``it``'s train step (the volume systems'
        occupancy refresh); nothing here."""

    def step_kind(self, batch: Dict[str, Any]) -> str:
        return "tables" if batch.get("light_table") is not None else "mc"

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        """One optimization step on ``batch``; every random draw comes from
        ``draws`` (see utils/rng.py)."""
        step = self.global_step
        loss_cfg = dict(self.cfg.loss)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.renderer.shade_view(
            self.field, batch["gbuffer"], batch["env_id"], draws,
            light_table=batch.get("light_table"), jitter_pts=batch.get("jitter_pts"),
            pixel_vis=batch.get("pixel_vis"),
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
            draws=None, val_check_interval: int = 100, checkpoint_every: int = 4000,
            save_train_image_iter: Optional[int] = None) -> Dict[str, Any]:
        """The training loop, from ``global_step`` to ``max_steps``.
        Returns {"field": MaterialField, "step": int}."""
        self.on_fit_start(seed)
        if self.field is None:
            self.init_state(seed)
        elif self.optimizer is None:
            self.optimizer = parse_optimizer(self.cfg.optimizer, self.field.parameters())
        if draws is None:
            draws = TorchDraws(seed + 2, self.device)
        log_dir = os.path.join(trial_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        cuda = self.device.type == "cuda"
        sync = (lambda: torch.cuda.synchronize(self.device)) if cuda else (lambda: None)
        grid_every = save_train_image_iter or self.cfg.save_train_image_iter
        # one metrics.csv per fit: rows of an earlier run into the same trial_dir go
        if os.path.exists(os.path.join(log_dir, "metrics.csv")):
            os.remove(os.path.join(log_dir, "metrics.csv"))
        wandb_cfg = dict(self.cfg.loggers.get("wandb", {})) if self.cfg.loggers else {}
        metric_logger = MultiLogger(
            CSVLogger(log_dir), TSVEventLogger(log_dir),
            TensorBoardLogger(os.path.join(trial_dir, "tb")),
            WandbLogger(wandb_cfg.get("project", "dreammat_tpu"),
                        enable=wandb_cfg.get("enable", False)))
        progress = ProgressWriter(os.path.join(trial_dir, "progress"))
        for it in range(self.global_step, max_steps):
            batch = datamodule.collate(step=it)
            draws.step = it
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.time()
            self.on_train_batch_start(it, draws)
            metrics = self.train_step(batch, draws)
            sync()
            self.step_seconds.append(time.time() - t0)
            self.step_losses.append(float(metrics["loss"]))
            self.step_kinds.append(self.step_kind(batch))
            if cuda:
                self.step_peak_gb.append(torch.cuda.max_memory_allocated(self.device) / 1e9)
            if (it + 1) % log_every == 0 or it + 1 == max_steps:
                m = {k: float(v) for k, v in metrics.items()}
                terms = " ".join(f"{k[5:]}={v:.5g}" for k, v in m.items()
                                 if k.startswith("loss_"))
                dreammat_tpu_torch.info("step %d loss=%.4f %s (%s, %.3f s/step)", it + 1,
                                        m["loss"], terms, self.step_kinds[-1],
                                        self.step_seconds[-1])
                metric_logger.log({**m, "seconds": self.step_seconds[-1]}, it + 1)
                progress.update(it + 1, max_steps)
            if self.cfg.save_train_image and grid_every and (it + 1) % grid_every == 0:
                self.save_train_grid(batch, trial_dir, it + 1)
            if val_check_interval and (it + 1) % val_check_interval == 0:
                self.validation(datamodule, trial_dir, it + 1)
            if checkpoint_every and (it + 1) % checkpoint_every == 0:
                self.save_checkpoint(trial_dir, it + 1)
        return {"field": self.field, "step": self.global_step}

    def save_checkpoint(self, trial_dir: str, step: int) -> str:
        return save_checkpoint(os.path.join(trial_dir, "ckpts", f"step{step:06d}"),
                               self.field.state_dict(), self.optimizer.state_dict(), step)

    # ------------------------------------------------------------------
    def render(self, gbuffer, env_id: int, light_table=None) -> Dict[str, torch.Tensor]:
        """An eval render of one view (no rotations, no gradient)."""
        with torch.no_grad():
            return self.renderer.shade_view(self.field, gbuffer, env_id, None,
                                            light_table=light_table, is_train=False)

    def save_train_grid(self, batch, trial_dir: str, step: int) -> str:
        """Render channels over the condition-map slices of the batch."""
        out = {k: v.cpu().numpy() for k, v in self.render(
            batch["gbuffer"], batch["env_id"], batch.get("light_table")).items()}
        cond = batch["condition_map"][0].permute(1, 2, 0).float().cpu().numpy()
        rows = [
            [{"img": out["comp_rgb"]}, {"img": out["specular_light"]},
             {"img": out["diffuse_light"]}, {"img": out["comp_normal"]},
             {"img": out["comp_depth"][..., 0]}, {"img": out["albedo"]},
             {"img": out["roughness"][..., 0]}, {"img": out["metalness"][..., 0]}],
            [{"img": cond[..., 0]}, {"img": cond[..., 1:4]}]
            + [{"img": cond[..., c:c + 3]} for c in range(4, 22, 3)],
        ]
        return saving.save_image_grid(os.path.join(trial_dir, "save", f"it{step}-train.png"), rows)

    def validation(self, datamodule, trial_dir: str, step: int) -> str:
        """PBR channels of the next training batch's view."""
        batch = datamodule.collate(step=step)
        out = {k: v.cpu().numpy() for k, v in self.render(
            batch["gbuffer"], batch["env_id"], batch.get("light_table")).items()}
        rows = [[{"img": out["comp_rgb"]}, {"img": out["albedo"]},
                 {"img": out["metalness"][..., 0]}, {"img": out["roughness"][..., 0]},
                 {"img": out["comp_normal"]}, {"img": out["comp_depth"][..., 0]}]]
        return saving.save_image_grid(os.path.join(trial_dir, "save", f"it{step}-val.png"), rows)

    def test(self, datamodule, trial_dir: str, step: int, n_views: Optional[int] = None) -> str:
        """The eval circle: per view ``save/it{step}-test/{i}.png`` and its
        albedo, roughness and metallic RGBA PNGs, then the gif."""
        n = n_views or datamodule.cfg.n_test_views
        d = os.path.join(trial_dir, "save", f"it{step}-test")
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        frames, self.test_seconds = [], []
        for i in range(n):
            t0 = time.time()
            batch = datamodule.eval_view(i)
            out = self.render(batch["gbuffer"], batch["env_id"], batch.get("light_table"))
            sync()
            self.test_seconds.append(time.time() - t0)
            rgb = out["comp_rgb"].cpu().numpy()
            alpha = out["opacity"][..., 0].cpu().numpy()
            saving.save_image(os.path.join(d, f"{i}.png"), rgb)
            saving.save_image_with_alpha(os.path.join(d, "albedo", f"{i}.png"),
                                         out["albedo"].cpu().numpy(), alpha)
            saving.save_image_with_alpha(os.path.join(d, "roughness", f"{i}.png"),
                                         out["roughness"][..., 0].cpu().numpy(), alpha)
            saving.save_image_with_alpha(os.path.join(d, "metallic", f"{i}.png"),
                                         out["metalness"][..., 0].cpu().numpy(), alpha)
            frames.append(rgb)
        return saving.save_gif(os.path.join(trial_dir, "save", f"it{step}-test.gif"), frames,
                               fps=30)

    def export(self, trial_dir: str, texture_size: Optional[int] = None) -> str:
        """Bake and write ``save/export/model.obj`` / ``model.mtl`` and the
        maps; the texture size comes from ``system.exporter.texture_size``
        (default 2048)."""
        from dreammat_tpu_torch.models.exporter import MeshExporter

        if texture_size is None:
            texture_size = int(dict(self.cfg.exporter or {}).get("texture_size", 2048))
        self.exporter = MeshExporter({"texture_size": texture_size}, self.geometry, self.material,
                                     device=self.device)
        return self.exporter.export_obj_with_mtl(self.field,
                                                 os.path.join(trial_dir, "save", "export"))
