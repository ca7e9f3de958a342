"""Control4D (multiview): GAN-assisted instructed editing of a capture.

Counterpart of ``control4d-multiview-system`` in
``dreammat_tpu/systems/control4d.py``, on the port's Instruct-NeRF2NeRF
(the edit cadence, ``edit_frames``, the perceptual tower). The renderer is
the GAN volume renderer over a ``hybrid-rgb-latent-material``; the frames'
targets are replaced by InstructPix2Pix edits of its GAN image (draws
under ``edit/``). The state (``GANScene``) is the volume scene plus the
four GAN networks, so checkpoints carry them; two optimizers train it:

- the generator side (field, background, generator, both encoders):
  lambda_l1 L1 + lambda_p perceptual + lambda_G hinge-G + lambda_kl KL and
  DreamFusion's orient, sparsity and opaque terms, where L1 is the
  stride-8 probe's error, plus the GAN image's error times the level
  ratio (1 at level 2, else 0.1), plus a quarter of that ratio times the
  error of the GAN image against the detached NeRF image, both shrunk
  4x; and the perceptual term is times 1 at levels 1 and 2, else 0.1.
  Parameters that a level leaves unused get zero gradients, so their
  Adam moments decay as optax's do;
- the PatchGAN discriminator (``optimizer_d``, Adam with betas (0.5, 0.9)):
  lambda_D hinge-D on the target and the generator step's GAN image,
  detached, as the JAX package's pair of jitted steps takes it.

Each step draws its generator level (``generator_level``, an integer in
[0, 3)) and takes the probe's offsets from ``np.random.RandomState(it)``
and ``RandomState(it + 1)`` on the host, as the JAX package does. The GAN
networks are built with the scene (their shapes do not depend on the
data), from the seed, with flax's init (``init_networks``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.detectors import resize_linear
from dreammat_tpu_torch.systems.dreamfusion import VolumeScene
from dreammat_tpu_torch.systems.instructnerf2nerf import InstructNeRF2NeRF
from dreammat_tpu_torch.systems.optimizers import parse_optimizer
from dreammat_tpu_torch.utils import gan, perceptual, saving
from dreammat_tpu_torch.utils.ckpt import save_checkpoint
from dreammat_tpu_torch.utils.rng import TorchDraws
from dreammat_tpu_torch.utils.schedule import C


class GANScene(VolumeScene):
    """A volume scene with the GAN renderer's networks (``gan``)."""

    def __init__(self, geo, bg, occ, nets):
        super().__init__(geo, bg, occ)
        self.gan = nets


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


@dreammat_tpu_torch.register("control4d-multiview-system")
class Control4D(InstructNeRF2NeRF):
    @dataclass
    class Config(InstructNeRF2NeRF.Config):
        renderer_type: str = "gan-volume-renderer"
        material_type: str = "hybrid-rgb-latent-material"
        per_editing_step: int = 20
        start_editing_step: int = 2000
        optimizer_d: dict = field(default_factory=lambda: {
            "name": "Adam", "args": {"lr": 2.0e-4, "betas": (0.5, 0.9)}})
        loss: dict = field(default_factory=lambda: {
            "lambda_l1": 10.0, "lambda_p": 10.0, "lambda_G": 1.0, "lambda_kl": 1.0e-6,
            "lambda_D": 1.0, "lambda_orient": 0.0, "lambda_sparsity": 0.0,
            "lambda_opaque": 0.0})

    cfg: Config

    def configure(self, device="cuda") -> None:
        super().configure(device)
        self.optimizer_d = None
        self.levels = []  # the generator level of each step

    def init_state(self, seed: int = 0) -> None:
        super().init_state(seed)
        nets = self.renderer.init_networks(
            torch.Generator(device=self.device).manual_seed(seed + 5))
        f = self.field
        self.field = GANScene(f.geo, f.bg, f.occ, nets)
        self.optimizer = parse_optimizer(
            self.cfg.optimizer, [*f.geo.parameters(), *f.bg.parameters(), *nets.generator_side()])
        self.optimizer_d = parse_optimizer(self.cfg.optimizer_d, nets.discriminator.parameters())

    def load_state(self, state_dict, optimizer_state=None, step: int = 0) -> None:
        """The scene with its GAN networks, both optimizers and the step."""
        if self.field is None:
            self.init_state()
        self.field.load_state_dict(state_dict, strict=True)
        if optimizer_state is not None:
            self.optimizer.load_state_dict(optimizer_state["g"])
            self.optimizer_d.load_state_dict(optimizer_state["d"])
        self.global_step = int(step)

    def save_checkpoint(self, trial_dir: str, step: int) -> str:
        return save_checkpoint(os.path.join(trial_dir, "ckpts", f"step{step:06d}"),
                               self.field.state_dict(),
                               {"g": self.optimizer.state_dict(),
                                "d": self.optimizer_d.state_dict()}, step)

    def render_batch(self, batch: Dict[str, Any], draws, is_train: bool, **kw):
        f = self.field
        return self.renderer.render_rays(f.geo, f.bg, f.occ, batch["rays_o"], batch["rays_d"],
                                         batch["light_positions"], draws,
                                         step=kw.pop("step", self.global_step),
                                         is_train=is_train, gan_nets=f.gan,
                                         height=batch["height"], width=batch["width"], **kw)

    def edit_render(self, batch: Dict[str, Any], draws) -> torch.Tensor:
        out = self.render_batch(batch, draws, is_train=False, step=0)
        return out["comp_gan_rgb"].reshape(1, batch["height"], batch["width"], 3)

    def generator_loss(self, out, gan_rgb, gt, level: int, step: int):
        """(weighted sum, metrics) of the generator side's losses."""
        loss_cfg = dict(self.cfg.loss)
        H, W = gt.shape[1:3]
        ratio = 1.0 if level == 2 else 0.1
        loss_l1 = torch.mean(torch.abs(out["comp_int_rgb"] - out["comp_gt_rgb"]))
        loss_l1 = loss_l1 + torch.mean(torch.abs(gan_rgb - gt)) * ratio
        lr_gan = resize_linear(_nchw(gan_rgb), (H // 4, W // 4))
        lr_nerf = resize_linear(_nchw(out["comp_rgb"].reshape(1, H, W, 3)),
                                (H // 4, W // 4)).detach()
        loss_l1 = loss_l1 + torch.mean(torch.abs(lr_gan - lr_nerf)) * ratio * 0.25
        loss_p = perceptual.perceptual_distance(self.vgg, gan_rgb, gt) * (
            1.0 if level >= 1 else 0.1)
        loss_G = gan.generator_loss(self.field.gan.discriminator, _nchw(gan_rgb))
        reg, metrics = self.regularizers(out, step)
        loss = (C(loss_cfg.get("lambda_l1", 0.0), step) * loss_l1
                + C(loss_cfg.get("lambda_p", 0.0), step) * loss_p
                + C(loss_cfg.get("lambda_G", 0.0), step) * loss_G
                + C(loss_cfg.get("lambda_kl", 0.0), step) * out["kl"] + reg)
        metrics.update(loss_l1=loss_l1, loss_p=loss_p, loss_G=loss_G, loss_kl=out["kl"])
        return loss, metrics

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        step = self.global_step
        self.maybe_edit(batch, step, draws)
        H, W = batch["height"], batch["width"]
        gt = self.target(batch).reshape(1, H, W, 3)
        level = int(draws.integers("generator_level", 0, 3, ()))
        offsets = (np.random.RandomState(step).randint(0, 8),
                   np.random.RandomState(step + 1).randint(0, 8))
        self.levels.append(level)
        nets = self.field.gan

        # the generator side, with the discriminator frozen
        nets.discriminator.requires_grad_(False)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.render_batch(batch, draws, is_train=True, gt_rgb=gt[0],
                                generator_level=level, int_offsets=offsets)
        gan_rgb = out["comp_gan_rgb"].reshape(1, H, W, 3)
        loss, metrics = self.generator_loss(out, gan_rgb, gt, level, step)
        loss.backward()
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        nets.discriminator.requires_grad_(True)

        # the discriminator, on the same fake
        self.optimizer_d.zero_grad(set_to_none=True)
        loss_d = gan.discriminator_loss(nets.discriminator, _nchw(gt), _nchw(gan_rgb)) * \
            C(dict(self.cfg.loss).get("lambda_D", 1.0), step + 1)
        loss_d.backward()
        self.optimizer_d.step()
        self.global_step += 1
        zero = torch.zeros((), device=self.device)
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                "loss_D": loss_d.detach(), "grad_norm": zero, "min_step": 0, "max_step": 0}

    # -- evaluation ---------------------------------------------------------
    def eval_out(self, batch: Dict[str, Any], step: int) -> Dict[str, torch.Tensor]:
        f = self.field
        return self.renderer.render_image(f.geo, f.bg, f.occ, batch["rays_o"], batch["rays_d"],
                                          batch["light_position"], TorchDraws(0, self.device),
                                          step=step, gan_nets=f.gan)

    def save_train_grid(self, batch, trial_dir: str, step: int) -> str:
        h, w = batch["height"], batch["width"]
        with torch.no_grad():
            out = self.render_batch(batch, TorchDraws(step, self.device), is_train=False)
        row = [{"img": out[k].reshape(h, w, 3).cpu().numpy()}
               for k in ("comp_rgb", "comp_gan_rgb")]
        return saving.save_image_grid(os.path.join(trial_dir, "save", f"it{step}-train.png"),
                                      [row])
