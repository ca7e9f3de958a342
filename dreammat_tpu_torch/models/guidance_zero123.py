"""Zero123 novel-view guidance: image- and relative-pose-conditioned SDS, and its VSD.

Counterpart of ``dreammat_tpu/models/guidance_zero123.py``:

- the UNet is SD2.1's layout with 8 input channels (the noisy latent and,
  channel-concatenated, the conditioning image's latent ``c_concat``),
  768-d context and convolutional transformer projections
  (``zero123_unet_config``); the VAE is SD's; the image tower is CLIP
  ViT-L/14 (``diffusion/clip_vision.py``);
- ``init_params`` embeds the conditioning image once: ``c_crossattn`` is its
  CLIP token [1,1,768], ``c_concat`` the VAE posterior mean, **unscaled**
  [1,4,h,w]; the render's latents are the scaled, sampled ``encode``;
- the context token is ``[c_crossattn, d_polar, sin d_azim, cos d_azim,
  d_dist] @ w + b`` (``cc_projection``, identity over the CLIP part and
  N(0, 1e-3) over the pose at init); the CFG's uncond row zeroes both the
  context token and the concat latent (``get_cond``);
- SDS: w(t) = 1 - a_t, grad = nan_to_num(w (eps_uncond + g (eps_cond -
  eps_uncond) - noise)), optionally clipped at the scheduled
  ``grad_clip``, loss_sds = 0.5 ||latents - stopgrad(latents - grad)||^2 / B.
  The UNet pass runs under ``torch.no_grad()`` (its output enters the loss
  only inside the stop-gradient).

The draws are ``vae_eps`` (not drawn with ``rgb_as_latents``), ``t`` and
``noise``. Weights: random-initialized, then the UNet, the VAE and the image
tower from ``cache_dir/{unet,vae,vision}`` (diffusers / transformers
layout) where those hold a checkpoint; ``half_precision_weights`` stores
them in bf16 (kernel A takes bf16 only).

``zero123-vsd-guidance`` replaces the SDS noise target by a LoRA copy of
the UNet trained online on the renders (``new_lora_state``,
``merged_unet_params`` of ``guidance_vsd.py``: the frozen UNet with its
attention projections merged functionally), camera-conditioned through the
UNet's class-embedding slot (the flattened c2w, 16, or the spherical
``[elevation, sin azimuth, cos azimuth, distance]``, 4). Its phi branch
keeps the concat latent conditioned in both CFG rows; ``loss_lora``
regresses the LoRA branch at fresh timesteps (draws ``t2``, ``noise2``
and, with ``lora_cfg_training``, ``camera_drop``: uniform [B,1] < 0.1
zeroes that sample's camera). No system of either package drives it: the
Zero123 systems pass no LoRA state (ROADMAP, queue 3). As the port's SD
VSD guidance, it returns no ``loss_sds`` alias of ``loss_vsd``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.clip_vision import CLIPVisionConfig, CLIPVisionModel
from dreammat_tpu_torch.models.diffusion.convert import build_on, load_model_dir, random_init_
from dreammat_tpu_torch.models.diffusion.scheduler import SchedulerConfig, add_noise, make_schedule
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from dreammat_tpu_torch.models.detectors import resize_linear
from dreammat_tpu_torch.models.guidance_vsd import LoRAState, merged_unet_params, new_lora_state
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.schedule import C


def zero123_unet_config() -> UNetConfig:
    """The Zero123 UNet: 8 input channels (latent + concat latent), 768-d
    CLIP context, convolutional transformer projections."""
    return replace(UNetConfig.sd21(), in_channels=8, cross_attention_dim=768,
                   use_linear_projection=False)


def load_rgba_composited(path: str, size: int) -> np.ndarray:
    """An RGBA file -> [size, size, 3] float RGB over a white background."""
    from PIL import Image

    img = Image.open(path).convert("RGBA").resize((size, size), Image.LANCZOS)
    rgba = np.asarray(img, dtype=np.float32) / 255.0
    return rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])


@dreammat_tpu_torch.register("zero123-guidance")
class Zero123Guidance(BaseObject):
    @dataclass
    class Config:
        pretrained_model_name_or_path: str = "load/zero123/105000.ckpt"
        cache_dir: Optional[str] = "model/zero123"
        cond_image_path: str = ""
        cond_elevation_deg: float = 0.0
        cond_azimuth_deg: float = 0.0
        cond_camera_distance: float = 1.2
        guidance_scale: float = 5.0
        grad_clip: Optional[Any] = None
        half_precision_weights: bool = False
        min_step_percent: Any = 0.02
        max_step_percent: Any = 0.98
        model_size: str = "zero123"  # "zero123" | "tiny"
        width: int = 256
        height: int = 256
        vram_O: bool = True
        max_items_eval: int = 4
        pretrained_config: str = ""

    cfg: Config
    # the UNet's class-embedding slot (the VSD guidance's camera): none here
    unet_class_embed_dim: Optional[int] = None

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.half_precision_weights else torch.float32
        tiny = cfg.model_size == "tiny"
        self.unet_cfg = replace(UNetConfig.tiny(), in_channels=8) if tiny \
            else zero123_unet_config()
        self.vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.sd()
        self.vision_cfg = CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig.vit_l14()
        assert self.vision_cfg.projection_dim == self.unet_cfg.cross_attention_dim
        # Zero123's LDM schedule is SD's: scaled-linear 0.00085 -> 0.012, 1000 steps
        self.schedule = make_schedule(SchedulerConfig(), device=self.device)
        self.num_train_timesteps = SchedulerConfig().num_train_timesteps
        self.unet = self.vae = self.vision = None

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    cond_rgb: Optional[np.ndarray] = None) -> None:
        """Random-initialize the UNet, the VAE, the image tower and
        ``cc_projection`` on the device, load the first three from
        ``cache_dir/{unet,vae,vision}`` where they hold a checkpoint, then
        embed the conditioning image (``cond_rgb`` [S,S,3] in [0,1], or the
        RGBA file ``cond_image_path`` composited over white):
        ``c_crossattn`` [1,1,D] and the unscaled ``c_concat`` [1,4,h,w]."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def make(fn):
            m = build_on(fn, self.device, self.dtype)
            return random_init_(m, generator).eval().requires_grad_(False)

        self.unet = make(lambda: UNet2DCondition(self.unet_cfg,
                                                 class_embed_dim=self.unet_class_embed_dim))
        self.vae = make(lambda: AutoencoderKL(self.vae_cfg))
        self.vision = make(lambda: CLIPVisionModel(self.vision_cfg))
        cross = self.unet_cfg.cross_attention_dim
        w_pose = torch.randn((4, cross), generator=generator, device=self.device) * 1e-3
        # stored as the weights are (bf16 with half_precision_weights), applied in fp32
        self.cc_w = torch.cat([torch.eye(cross, device=self.device), w_pose]).to(self.dtype)
        self.cc_b = torch.zeros(cross, device=self.device, dtype=self.dtype)
        self.loaded = {}
        if cfg.cache_dir:
            for sub, module, kind in (("unet", self.unet, "unet"), ("vae", self.vae, "vae"),
                                      ("vision", self.vision, "clip_vision")):
                report = load_model_dir(module, os.path.join(str(cfg.cache_dir), sub), kind)
                if report is not None:
                    self.loaded[sub] = report
        if cond_rgb is None:
            if not (cfg.cond_image_path and os.path.exists(cfg.cond_image_path)):
                raise FileNotFoundError(f"cond_image_path {cfg.cond_image_path!r} not found "
                                        "and no cond_rgb array given")
            cond_rgb = load_rgba_composited(cfg.cond_image_path, cfg.height)
        cond = torch.as_tensor(np.asarray(cond_rgb, np.float32), device=self.device)
        self.embed_condition(resize_linear(cond.permute(2, 0, 1)[None], (cfg.height, cfg.width)))

    @torch.no_grad()
    def embed_condition(self, cond: torch.Tensor) -> None:
        """The conditioning image [1,3,S,S] in [0,1] -> ``c_crossattn`` (its
        CLIP token) and ``c_concat`` (its unscaled VAE posterior mean)."""
        self.cond_rgb = cond
        self.c_crossattn = self.vision(cond).float()
        self.c_concat = self.vae.encode_moments(cond * 2.0 - 1.0)[0].float()

    def encode_images(self, rgb: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
        """[B,3,H,W] in [0,1] -> scaled latents [B,4,h,w] (fp32)."""
        return self.vae.encode(rgb * 2.0 - 1.0, eps).float()

    def cond_tokens(self, elevation, azimuth, camera_distances):
        """The conditioned tokens: the image and relative-pose context token
        [B,1,D] and the clean image latent [B,4,h,w]."""
        cfg = self.cfg
        B = elevation.shape[0]
        d2r = np.pi / 180.0
        pose = torch.stack([
            d2r * ((90.0 - elevation) - (90.0 - cfg.cond_elevation_deg)),
            torch.sin(d2r * (azimuth - cfg.cond_azimuth_deg)),
            torch.cos(d2r * (azimuth - cfg.cond_azimuth_deg)),
            camera_distances - cfg.cond_camera_distance,
        ], dim=-1)[:, None, :].float()
        img_tok = self.c_crossattn.expand(B, 1, -1)
        clip_emb = torch.cat([img_tok, pose], dim=-1) @ self.cc_w.float() + self.cc_b.float()
        return clip_emb, self.c_concat.expand(B, -1, -1, -1)

    def get_cond(self, elevation, azimuth, camera_distances):
        """The CFG-stacked conditioning: row block 0 uncond (zeroed context
        token and zeroed concat latent), row block 1 cond."""
        clip_emb, cc = self.cond_tokens(elevation, azimuth, camera_distances)
        return (torch.cat([torch.zeros_like(clip_emb), clip_emb]),
                torch.cat([torch.zeros_like(cc), cc]))

    def latents_of(self, rgb: torch.Tensor, draws, rgb_as_latents: bool) -> torch.Tensor:
        """The render at the guidance's size as latents: resized to the
        latent size and mapped to [-1, 1] (``rgb_as_latents``), or resized
        to width x height and encoded with the ``vae_eps`` draw."""
        cfg = self.cfg
        B, f = rgb.shape[0], self.vae_factor
        lh, lw = cfg.height // f, cfg.width // f
        if rgb_as_latents:
            return resize_linear(rgb, (lh, lw)) * 2.0 - 1.0
        img = resize_linear(rgb, (cfg.height, cfg.width))
        return self.encode_images(img, draws.normal("vae_eps",
                                                    (B, self.vae_cfg.latent_channels, lh, lw)))

    def timesteps(self, B: int, step: int, draws):
        """(t [B], min_step, max_step): t uniform over the scheduled window,
        from the ``t`` draw."""
        cfg = self.cfg
        T = self.num_train_timesteps
        min_step = int(round(T * C(cfg.min_step_percent, step)))
        max_step = int(round(T * C(cfg.max_step_percent, step)))
        u = draws.uniform("t", (B,)).to(self.device)
        t = (min_step + u * float(max_step - min_step + 1)).to(torch.int64)
        return torch.clamp(t, 0, T - 1), min_step, max_step

    def sds_loss(self, latents, noise, t, eps_cfg, eps_target, step: int):
        """(loss, grad): grad = nan_to_num((1 - a_t)(eps_cfg - eps_target)),
        clipped at ``grad_clip``; loss = 0.5 ||latents - sg(latents - grad)||^2 / B."""
        cfg = self.cfg
        w = (1.0 - self.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1)
        grad = torch.nan_to_num(w * (eps_cfg - eps_target))
        if cfg.grad_clip is not None:
            clip = C(cfg.grad_clip, step)
            grad = torch.clamp(grad, -clip, clip)
        target = (latents - grad).detach()
        return 0.5 * torch.sum((latents - target) ** 2) / latents.shape[0], grad

    def __call__(self, rgb: torch.Tensor, elevation, azimuth, camera_distances, step: int = 0,
                 draws=None, rgb_as_latents: bool = False) -> Dict[str, torch.Tensor]:
        """rgb [B,3,H,W] in [0,1] at any size (resized to the guidance's)."""
        B = rgb.shape[0]
        latents = self.latents_of(rgb, draws, rgb_as_latents)
        t, min_step, max_step = self.timesteps(B, step, draws)
        noise = draws.normal("noise", tuple(latents.shape)).to(self.device)
        latents_noisy = add_noise(self.schedule, latents, noise, t).detach()
        context, concat = self.get_cond(elevation, azimuth, camera_distances)
        with torch.no_grad():
            eps = self.unet(torch.cat([torch.cat([latents_noisy] * 2), concat], dim=1),
                            torch.cat([t] * 2), context)
        eps_uncond, eps_cond = eps.chunk(2)
        eps_cfg = eps_uncond + self.cfg.guidance_scale * (eps_cond - eps_uncond)
        loss_sds, grad = self.sds_loss(latents, noise, t, eps_cfg, noise, step)
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad.detach()),
                "min_step": min_step, "max_step": max_step}


@dreammat_tpu_torch.register("zero123-vsd-guidance")
class Zero123VSDGuidance(Zero123Guidance):
    @dataclass
    class Config(Zero123Guidance.Config):
        guidance_scale_phi: float = 1.0
        lora_rank: int = 4
        lora_cfg_training: bool = False
        lora_n_timestamp_samples: int = 1
        camera_condition_type: str = "extrinsics"  # | "spherical"

    cfg: Config

    @property
    def unet_class_embed_dim(self) -> int:
        """16 (a flattened c2w) or 4 (spherical)."""
        return 16 if self.cfg.camera_condition_type == "extrinsics" else 4

    def init_lora(self, generator: torch.Generator) -> LoRAState:
        """Fresh LoRA factors and camera embedding (``new_lora_state``)."""
        assert self.unet is not None, "init_params first"
        state = new_lora_state(self.unet, self.cfg.lora_rank, self.unet_class_embed_dim,
                               self.unet_cfg.block_out_channels[0] * 4, generator, self.device)
        dreammat_tpu_torch.info("zero123 VSD lora: %d sites (rank %d) + camera embedding",
                                len(state.layers.sites), self.cfg.lora_rank)
        return state

    def camera_condition(self, elevation, azimuth, camera_distances, c2w) -> torch.Tensor:
        ctype = self.cfg.camera_condition_type
        if ctype == "extrinsics":
            return c2w.reshape(c2w.shape[0], 16).float()
        if ctype == "spherical":
            d2r = np.pi / 180.0
            return torch.stack([d2r * elevation, torch.sin(d2r * azimuth),
                                torch.cos(d2r * azimuth), camera_distances], dim=-1).float()
        raise ValueError(f"Unknown camera_condition_type {ctype}")

    def __call__(self, rgb: torch.Tensor, elevation, azimuth, camera_distances,
                 c2w: Optional[torch.Tensor] = None, lora: Optional[LoRAState] = None,
                 step: int = 0, draws=None, rgb_as_latents: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """rgb [B,3,H,W] in [0,1], c2w [B,4,4], ``lora`` the trainable state."""
        if lora is None:
            raise ValueError("zero123-vsd-guidance needs the LoRA state (init_lora)")
        cfg = self.cfg
        B = rgb.shape[0]
        latents = self.latents_of(rgb, draws, rgb_as_latents)
        t, min_step, max_step = self.timesteps(B, step, draws)
        noise = draws.normal("noise", tuple(latents.shape)).to(self.device)
        latents_noisy = add_noise(self.schedule, latents, noise, t).detach()
        t_in = torch.cat([t] * 2)
        context, concat = self.get_cond(elevation, azimuth, camera_distances)
        clip_emb, cc = self.cond_tokens(elevation, azimuth, camera_distances)
        cam = self.camera_condition(elevation, azimuth, camera_distances, c2w)
        merged = merged_unet_params(self.unet, lora, self.dtype)
        with torch.no_grad():
            # the pretrained branch: Zero123's CFG
            eps_uncond, eps_cond = self.unet(
                torch.cat([torch.cat([latents_noisy] * 2), concat], dim=1), t_in,
                context).chunk(2)
            # the phi branch: camera CFG, the concat latent conditioned in both rows
            eps_cam, eps_unc = functional_call(
                self.unet, merged,
                (torch.cat([torch.cat([latents_noisy] * 2), torch.cat([cc] * 2)], dim=1), t_in,
                 torch.cat([clip_emb] * 2)),
                {"class_labels": torch.cat([cam, torch.zeros_like(cam)])}).chunk(2)
        eps_pretrain = eps_uncond + cfg.guidance_scale * (eps_cond - eps_uncond)
        eps_phi = eps_unc + cfg.guidance_scale_phi * (eps_cam - eps_unc)
        loss_vsd, grad = self.sds_loss(latents, noise, t, eps_pretrain, eps_phi, step)

        # train phi on the current render distribution
        n_ts = cfg.lora_n_timestamp_samples
        lat_d = latents.detach().repeat(n_ts, 1, 1, 1)
        t2 = draws.integers("t2", 0, self.num_train_timesteps, (B * n_ts,)).to(self.device)
        noise2 = draws.normal("noise2", tuple(lat_d.shape)).to(self.device)
        noisy2 = add_noise(self.schedule, lat_d, noise2, t2)
        cam_l = cam
        if cfg.lora_cfg_training:
            drop = draws.uniform("camera_drop", (B, 1)).to(self.device) < 0.1
            cam_l = torch.where(drop, torch.zeros_like(cam), cam)
        eps_pred = functional_call(
            self.unet, merged,
            (torch.cat([noisy2, cc.repeat(n_ts, 1, 1, 1)], dim=1), t2,
             clip_emb.detach().repeat(n_ts, 1, 1)),
            {"class_labels": cam_l.repeat(n_ts, 1)})
        loss_lora = torch.mean((eps_pred.float() - noise2) ** 2)
        return {"loss_vsd": loss_vsd, "loss_lora": loss_lora,
                "grad_norm": torch.linalg.norm(grad.detach()),
                "min_step": min_step, "max_step": max_step}
