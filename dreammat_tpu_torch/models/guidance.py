"""Score-distillation guidance: SD 2.1 + the 22-channel light ControlNet.

Counterpart of ``dreammat_tpu/models/guidance.py`` (non-Perp-Neg branch):

    grad = w(t) (cond_scale eps_text + uncond_scale eps_uncond
                 + null_scale eps_null + noise_scale noise)
    loss = 0.5 ||latents - stopgrad(latents - grad)||^2 / B

with step-scheduled scales, the scheduled timestep window, the ControlNet
condition-scale anneal, and the three CFG replicas (text, uncond, null) in
one batched ControlNet + UNet pass under ``torch.no_grad()`` (the JAX
stop-gradient). The condition stack stays batch 1, so the ControlNet's
image-resolution stem runs once for the three replicas.

Weights are random-initialized (no checkpoints exist for this repository
yet); ``half_precision_weights`` stores them in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
from dreammat_tpu_torch.models.diffusion.convert import build_on, random_init_
from dreammat_tpu_torch.models.diffusion.scheduler import SchedulerConfig, add_noise, make_schedule
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("stable-diffusion-dreammat-guidance")
class StableDiffusionLightGuidance(BaseObject):
    @dataclass
    class Config:
        width: int = 512
        height: int = 512
        cache_dir: Optional[str] = "model"
        pretrained_model_name_or_path: str = "stabilityai/stable-diffusion-2-1-base"
        controlnet_path: Optional[str] = "model/controlnet"
        half_precision_weights: bool = True
        use_controlnet: bool = True
        control_types: List = field(default_factory=lambda: ["light"])
        condition_scales: List = field(default_factory=lambda: [1.0])
        condition_scales_anneal: List = field(default_factory=lambda: [1.0])
        control_anneal_start_step: Optional[int] = None
        control_anneal_end_scale: Optional[float] = None
        min_step_percent: Any = 0.02
        max_step_percent: Any = 0.98
        cond_scale: Any = 1.0
        uncond_scale: Any = 0.0
        null_scale: Any = -1.0
        noise_scale: Any = 0.0
        perpneg_scale: Any = 0.0
        view_dependent_prompting: bool = True
        grad_clip_val: Optional[float] = None
        grad_normalize: bool = False
        model_size: str = "sd21"
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
        self.unet_cfg = UNetConfig.tiny() if tiny else UNetConfig.sd21()
        self.vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.sd()
        channels = {"light": 22, "depth": 3, "normal": 3}
        self.controlnet_cfgs = [
            ControlNetConfig(unet=self.unet_cfg, conditioning_channels=channels[ct],
                             conditioning_embedding_channels=(16, 32) if tiny else (16, 32, 96, 256))
            for ct in (cfg.control_types if cfg.use_controlnet else [])
        ]
        self.schedule = make_schedule(SchedulerConfig(), device=self.device)
        self.num_train_timesteps = SchedulerConfig().num_train_timesteps
        self.unet = self.vae = None
        self.controlnets: List[ControlNet] = []

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Random-initialize the frozen UNet, VAE and ControlNets on the device."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def make(fn):
            m = build_on(fn, self.device, self.dtype)
            return random_init_(m, generator).eval().requires_grad_(False)

        self.unet = make(lambda: UNet2DCondition(self.unet_cfg))
        self.vae = make(lambda: AutoencoderKL(self.vae_cfg))
        self.controlnets = [make(lambda c=c: ControlNet(c)) for c in self.controlnet_cfgs]

    def encode_images(self, rgb: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
        """[B,3,H,W] in [0,1] -> scaled latents [B,4,h,w] (fp32)."""
        return self.vae.encode(rgb * 2.0 - 1.0, eps).float()

    def noise_pred(self, latents_noisy, t, text_embeddings, image_cond, scales, n_copies: int):
        """Batched eps prediction on ``n_copies`` replicas of the latent."""
        latent_in = torch.cat([latents_noisy] * n_copies, dim=0)
        t_in = torch.cat([t] * n_copies, dim=0)
        down = mid = None
        if image_cond is not None:
            for cnet, cond, scale in zip(self.controlnets, image_cond, scales):
                if cond.shape[0] != 1:
                    cond = torch.cat([cond] * n_copies, dim=0)
                d, m = cnet(latent_in, t_in, text_embeddings, cond, scale)
                if down is None:
                    down, mid = list(d), m
                else:
                    down = [a + b for a, b in zip(down, d)]
                    mid = mid + m
        return self.unet(latent_in, t_in, text_embeddings,
                         down_block_additional_residuals=down,
                         mid_block_additional_residual=mid)

    def _image_conditions(self, condition_map: torch.Tensor) -> List[torch.Tensor]:
        """condition_map [B,22,h,w] -> per control type, at guidance resolution."""
        cfg = self.cfg

        def prep(cond, want_channels=None):
            if want_channels == 3 and cond.shape[1] == 1:
                cond = cond.repeat(1, 3, 1, 1)
            if cond.shape[2] != cfg.height or cond.shape[3] != cfg.width:
                cond = F.interpolate(cond, size=(cfg.height, cfg.width), mode="bilinear",
                                     align_corners=False, antialias=True)
            return cond

        out = []
        for ct in cfg.control_types:
            if ct == "light":
                out.append(prep(condition_map))
            elif ct == "depth":
                out.append(prep(condition_map[:, 0:1], want_channels=3))
            elif ct == "normal":
                out.append(prep(condition_map[:, 1:4]))
            else:
                raise ValueError(f"unsupported control type {ct}")
        return out

    def condition_scales_at(self, step: int) -> List[float]:
        cfg = self.cfg
        scales = []
        for i, s in enumerate(cfg.condition_scales):
            s_ann = cfg.condition_scales_anneal[i] if i < len(cfg.condition_scales_anneal) else s
            if cfg.control_anneal_start_step is None or step <= cfg.control_anneal_start_step:
                scales.append(float(s))
            else:
                scales.append(float(s_ann))
        return scales

    def __call__(self, rgb: torch.Tensor, prompt_utils, elevation, azimuth, camera_distances,
                 condition_map: Optional[torch.Tensor], step: int, draws) -> Dict[str, torch.Tensor]:
        """rgb [B,3,H,W] in [0,1]; condition_map [B,22,h,w]. The VAE posterior
        eps, the timestep and the latent noise come from ``draws``."""
        cfg = self.cfg
        if prompt_utils.use_perp_neg:
            raise NotImplementedError("Perp-Neg is not ported yet")
        B = rgb.shape[0]
        f = self.vae_factor
        lat_shape = (B, self.vae_cfg.latent_channels, rgb.shape[2] // f, rgb.shape[3] // f)
        latents = self.encode_images(rgb, draws.normal("vae_eps", lat_shape))

        T = self.num_train_timesteps
        min_step = int(round(T * C(cfg.min_step_percent, step)))
        max_step = int(round(T * C(cfg.max_step_percent, step)))
        u = draws.uniform("t", (B,))
        t = (min_step + u * float(max_step - min_step + 1)).to(torch.int64)
        t = torch.clamp(t, 0, T - 1)
        noise = draws.normal("noise", tuple(latents.shape))
        latents_noisy = add_noise(self.schedule, latents, noise, t)

        scales = self.condition_scales_at(step) if cfg.use_controlnet else []
        image_cond = self._image_conditions(condition_map) if cfg.use_controlnet else None
        text_embeddings = prompt_utils.get_text_embeddings(
            elevation, azimuth, camera_distances,
            view_dependent_prompting=cfg.view_dependent_prompting)
        with torch.no_grad():
            eps = self.noise_pred(latents_noisy.detach(), t, text_embeddings, image_cond, scales, 3)
        eps_text, eps_uncond, eps_null = eps.chunk(3, dim=0)

        w = (1.0 - self.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1)
        grad = w * (C(cfg.cond_scale, step) * eps_text + C(cfg.uncond_scale, step) * eps_uncond
                    + C(cfg.null_scale, step) * eps_null + C(cfg.noise_scale, step) * noise)
        grad = torch.nan_to_num(grad)
        if cfg.grad_clip_val is not None:
            grad = torch.clamp(grad, -cfg.grad_clip_val, cfg.grad_clip_val)
        if cfg.grad_normalize:
            grad = grad / (torch.linalg.norm(grad) + 1e-8)
        target = (latents - grad).detach()
        loss_sds = 0.5 * torch.sum((latents - target) ** 2) / B
        return {
            "loss_sds": loss_sds,
            "grad_norm": torch.linalg.norm(grad),
            "min_step": min_step,
            "max_step": max_step,
        }
