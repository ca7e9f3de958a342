"""InstructPix2Pix guidance: text-instructed image editing for NeRF editing.

Counterpart of ``stable-diffusion-instructpix2pix-guidance`` in
``dreammat_tpu/models/guidance_ip2p.py``. The IP2P UNet (SD 2.1's with 8
input channels and 768-wide cross-attention, ``ip2p_unet_config``) takes
the noisy latent channel-concatenated with the conditioning image's
latent, and runs three CFG replicas in one batch, [text + image,
image only, uncond] with the embeddings [pos, neg, neg] and the condition
latents [mean, mean, 0] (the posterior mean, unscaled):

    eps = e_unc + guidance_scale (e_text - e_img) + condition_scale (e_img - e_unc)

Two modes:

- default (Instruct-NeRF2NeRF's iterative dataset update, ``edit_latents``):
  the render's latent is noised to a drawn t, then denoised by
  ``diffusion_steps`` DDIM steps down the ladder
  ts_i = round(t (S - i) / S), conditioned on the original view and the
  instruction, and decoded: ``edit_images`` replace the training target.
  The JAX ladder's end is kept: its guard ``ts_{i+1} >= 0`` always holds,
  so the last step lands on alphas_cumprod[0], not 1 (ROADMAP, queue 3).
- ``use_sds``: the same eps drives an SDS gradient, w(t) = 1 - a_t.

Both take NHWC images in [0, 1] (the render and the original view), resize
them to ``fixed_size`` (or down to a multiple of the VAE factor) with the
half-pixel linear filter of ``jax.image.resize``, antialiased when it
shrinks (``detectors.resize_linear``), and resize the edit back. The UNet
runs under ``torch.no_grad`` (the JAX package stop-gradients it). The draws
are ``vae_eps`` (the render's posterior sample), ``t`` and ``noise`` (the
SDS noise, or the edit's starting noise).

Weights: random-initialized, then the UNet and the VAE from
``cache_dir/{unet,vae}`` (diffusers layout, ``load_model_dir``) where those
hold a checkpoint; bf16 with ``half_precision_weights``. The prompt
processor must give 768-wide embeddings at full width (its ``model_size:
ip2p``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.detectors import resize_linear
from dreammat_tpu_torch.models.diffusion.convert import build_on, load_model_dir, random_init_
from dreammat_tpu_torch.models.diffusion.scheduler import SchedulerConfig, add_noise, make_schedule
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.schedule import C


def ip2p_unet_config() -> UNetConfig:
    """timbrooks/instruct-pix2pix: the UNet with 8 input channels and
    768-wide cross-attention."""
    return replace(UNetConfig.sd21(), in_channels=8, cross_attention_dim=768,
                   use_linear_projection=False)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


@dreammat_tpu_torch.register("stable-diffusion-instructpix2pix-guidance")
class InstructPix2PixGuidance(BaseObject):
    @dataclass
    class Config:
        cache_dir: Optional[str] = None
        ddim_scheduler_name_or_path: str = "CompVis/stable-diffusion-v1-4"
        ip2p_name_or_path: str = "timbrooks/instruct-pix2pix"
        guidance_scale: float = 7.5
        condition_scale: float = 1.5
        grad_clip: Optional[Any] = None
        half_precision_weights: bool = True
        fixed_size: int = -1
        min_step_percent: Any = 0.02
        max_step_percent: Any = 0.98
        diffusion_steps: int = 20
        use_sds: bool = False
        model_size: str = "ip2p"  # "ip2p" | "tiny"
        enable_memory_efficient_attention: bool = False
        enable_sequential_cpu_offload: bool = False
        enable_attention_slicing: bool = False
        enable_channels_last_format: bool = False

    cfg: Config

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.half_precision_weights else torch.float32
        tiny = cfg.model_size == "tiny"
        self.unet_cfg = replace(UNetConfig.tiny(), in_channels=8) if tiny else ip2p_unet_config()
        self.vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.sd()
        self.schedule = make_schedule(SchedulerConfig(), device=self.device)
        self.num_train_timesteps = SchedulerConfig().num_train_timesteps
        self.unet = self.vae = None

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """The frozen UNet and VAE on the device, random, then loaded from
        ``cache_dir/{unet,vae}`` where they hold a checkpoint (``self.loaded``
        keeps each load's report)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def make(fn):
            m = build_on(fn, self.device, self.dtype)
            return random_init_(m, generator).eval().requires_grad_(False)

        self.unet = make(lambda: UNet2DCondition(self.unet_cfg))
        self.vae = make(lambda: AutoencoderKL(self.vae_cfg))
        self.loaded = {}
        if self.cfg.cache_dir:
            for name, module in (("unet", self.unet), ("vae", self.vae)):
                report = load_model_dir(module, os.path.join(str(self.cfg.cache_dir), name), name)
                if report is not None:
                    self.loaded[name] = report

    # ------------------------------------------------------------------
    def encode_images(self, rgb: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
        """[B,3,H,W] in [0,1] -> scaled latents [B,4,h,w] (fp32)."""
        return self.vae.encode(rgb * 2.0 - 1.0, eps).float()

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> [B,3,H,W] in [0,1] (fp32)."""
        img = self.vae.decode(latents).float()
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

    def cond_latents(self, cond_rgb: torch.Tensor) -> torch.Tensor:
        """The condition stack [mean, mean, 0] [3B,4,h,w] of the original
        view [B,3,H,W]: the posterior mean, unscaled (diffusers' IP2P)."""
        mean = self.vae.encode_moments(cond_rgb * 2.0 - 1.0)[0].float()
        return torch.cat([mean, mean, torch.zeros_like(mean)], dim=0)

    @torch.no_grad()
    def eps3(self, latents: torch.Tensor, cond3: torch.Tensor, t: torch.Tensor,
             emb3: torch.Tensor) -> torch.Tensor:
        """The guided eps of the three replicas' one batched UNet pass."""
        x = torch.cat([torch.cat([latents] * 3, dim=0), cond3], dim=1)
        out = self.unet(x, torch.cat([t] * 3, dim=0), emb3).float()
        e_text, e_img, e_unc = out.chunk(3, dim=0)
        return (e_unc + self.cfg.guidance_scale * (e_text - e_img)
                + self.cfg.condition_scale * (e_img - e_unc))

    @torch.no_grad()
    def edit_latents(self, emb3, latents, cond3, t: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
        """The partial DDIM re-denoise from t: ``diffusion_steps`` steps from
        ts_0 = t down the ladder of the module docstring."""
        S = self.cfg.diffusion_steps
        T = self.num_train_timesteps
        ac = self.schedule["alphas_cumprod"]
        x = add_noise(self.schedule, latents, noise, t)
        tf = t.float()
        ts_at = lambda i: torch.round(tf * (S - i) / S).to(torch.int64)
        for i in range(S):
            ti = torch.clamp(ts_at(i), 0, T - 1)
            tp = torch.clamp(ts_at(i + 1), 0, T - 1)
            eps = self.eps3(x, cond3, ti, emb3)
            a_t = ac[ti].reshape(-1, 1, 1, 1)
            a_p = ac[tp].reshape(-1, 1, 1, 1)  # the JAX guard ts_{i+1} >= 0 always holds
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            x = torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps
        return x

    def _timesteps(self, B: int, step: int, draws):
        T = self.num_train_timesteps
        min_step = int(round(T * C(self.cfg.min_step_percent, step)))
        max_step = int(round(T * C(self.cfg.max_step_percent, step)))
        u = draws.uniform("t", (B,)).to(self.device)
        t = (min_step + u * float(max_step - min_step + 1)).to(torch.int64)
        return torch.clamp(t, 0, T - 1), min_step, max_step

    def __call__(self, rgb: torch.Tensor, cond_rgb: torch.Tensor, prompt_utils, step: int,
                 draws) -> Dict[str, torch.Tensor]:
        """rgb, the render, and cond_rgb, the original view: [B,H,W,3] in
        [0,1]. Returns ``edit_images`` [B,H,W,3], or with ``use_sds``
        ``loss_sds``, ``grad_norm``, ``min_step`` and ``max_step``."""
        cfg = self.cfg
        B, H, W, _ = rgb.shape
        f = self.vae_factor
        RH, RW = (cfg.fixed_size, cfg.fixed_size) if cfg.fixed_size > 0 else \
            (H // f * f, W // f * f)
        rgb_r = resize_linear(_nchw(rgb), (RH, RW))
        with torch.no_grad():
            cond3 = self.cond_latents(resize_linear(_nchw(cond_rgb), (RH, RW)))
        lat_shape = (B, self.vae_cfg.latent_channels, RH // f, RW // f)
        latents = self.encode_images(rgb_r, draws.normal("vae_eps", lat_shape).to(self.device))

        zero = torch.zeros(B, device=self.device)
        emb = prompt_utils.get_text_embeddings(zero, zero, zero, view_dependent_prompting=False,
                                               return_null=False)
        emb3 = torch.cat([emb, emb[B:]], dim=0)  # [pos, neg, neg]
        t, min_step, max_step = self._timesteps(B, step, draws)
        noise = draws.normal("noise", lat_shape).to(self.device)

        if cfg.use_sds:
            latents_noisy = add_noise(self.schedule, latents, noise, t)
            eps = self.eps3(latents_noisy.detach(), cond3, t, emb3)
            w = (1.0 - self.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1)
            grad = torch.nan_to_num(w * (eps - noise))
            if cfg.grad_clip is not None:
                cv = C(cfg.grad_clip, step)
                grad = torch.clamp(grad, -cv, cv)
            target = (latents - grad).detach()
            return {"loss_sds": 0.5 * torch.sum((latents - target) ** 2) / B,
                    "grad_norm": torch.linalg.norm(grad),
                    "min_step": min_step, "max_step": max_step}
        with torch.no_grad():
            edit = self.edit_latents(emb3, latents.detach(), cond3, t, noise)
            imgs = resize_linear(self.decode_latents(edit), (H, W))
        return {"edit_images": imgs.permute(0, 2, 3, 1)}
