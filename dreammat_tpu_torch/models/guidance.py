"""Score-distillation guidance: SD 2.1 + the 22-channel light ControlNet.

Counterpart of ``dreammat_tpu/models/guidance.py``:

    grad = w(t) (cond_scale eps_text + uncond_scale eps_uncond
                 + null_scale eps_null + noise_scale noise
                 + perpneg_scale eps_perpneg)
    loss = 0.5 ||latents - stopgrad(latents - grad)||^2 / B

with step-scheduled scales, the scheduled timestep window, the ControlNet
condition-scale anneal, and the CFG replicas in one batched ControlNet +
UNet pass under ``torch.no_grad()`` (the JAX stop-gradient): three (text,
uncond, null), or with Perp-Neg five (text, uncond, two interpolated
negatives interleaved per sample, null), where ``eps_perpneg`` sums the
negatives' components perpendicular to ``eps_text - eps_uncond``, weighted
per view. Each row runs on its own sample's latent (``perp_neg_rows``); the
JAX package and the reference replicate the latents in blocks of B, so
there at B > 1 a negative row runs on another sample's latent (ROADMAP,
queue 3; DreamMat trains at B = 1, where the two agree). The condition
stack stays batch 1, so the ControlNet's image-resolution stem runs once
for all replicas.

Weights: random-initialized, then the UNet and the VAE are loaded from
``cache_dir/{unet,vae}`` (diffusers layout, ``strict=False`` through
``convert.load_diffusers_weights``, which logs the keys loaded, missing and
unused) and a trained ControlNet from ``controlnet_path``
(``diffusion_pytorch_model.safetensors``, as
``ControlNetTrainer.export_diffusers`` writes it), strictly, into the
first ControlNet, where those exist; ``half_precision_weights`` stores them
in bf16.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
from dreammat_tpu_torch.models.diffusion.convert import (
    build_on, find_checkpoint_file, load_model_dir, load_state_dict_file, random_init_,
)
from dreammat_tpu_torch.models.diffusion.scheduler import SchedulerConfig, add_noise, make_schedule
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import perpendicular_component
from dreammat_tpu_torch.utils.schedule import C


def perp_neg_rows(B: int, null: bool, device) -> torch.Tensor:
    """The sample of each row of a Perp-Neg pass: text and uncond in blocks
    of B, then the two negatives interleaved per sample ([b0, b0, b1, b1,
    ...], as the prompt embeddings order them), then (with ``null``) the null
    block. Each negative thus runs on its own sample's latent; replicating
    the latents in blocks, as the JAX package and the reference do, pairs
    sample b's negatives with other samples' latents when B > 1."""
    b = torch.arange(B, device=device)
    return torch.cat([b, b, b.repeat_interleave(2)] + ([b] if null else []))


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
    # the UNet's class-embedding slot (the VSD guidance's camera): none here
    unet_class_embed_dim: Optional[int] = None

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.half_precision_weights else torch.float32
        tiny = cfg.model_size == "tiny"
        self.unet_cfg = UNetConfig.tiny() if tiny else UNetConfig.sd21()
        self.vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.sd()
        # subclasses (the triple guidance) extend the control-type set
        channels = getattr(self, "_cn_channels", {"light": 22, "depth": 3, "normal": 3})
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
        """Random-initialize the frozen UNet, VAE and ControlNets on the device,
        then load the UNet and the VAE from ``cache_dir/{unet,vae}`` and a
        trained ControlNet from ``controlnet_path`` where they hold one.
        ``self.loaded`` keeps each load's report (``load_diffusers_weights``)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def make(fn):
            m = build_on(fn, self.device, self.dtype)
            return random_init_(m, generator).eval().requires_grad_(False)

        self.unet = make(lambda: UNet2DCondition(self.unet_cfg,
                                                 class_embed_dim=self.unet_class_embed_dim))
        self.vae = make(lambda: AutoencoderKL(self.vae_cfg))
        self.controlnets = [make(lambda c=c: ControlNet(c)) for c in self.controlnet_cfgs]
        self.loaded = {}
        if self.cfg.cache_dir:
            for name, module in (("unet", self.unet), ("vae", self.vae)):
                report = load_model_dir(module, os.path.join(str(self.cfg.cache_dir), name), name)
                if report is not None:
                    self.loaded[name] = report
        path = self.cfg.controlnet_path
        if self.controlnets and path and os.path.isdir(str(path)):
            ckpt = find_checkpoint_file(str(path))
            if ckpt:
                self.controlnets[0].load_state_dict(load_state_dict_file(ckpt), strict=True)
                dreammat_tpu_torch.info("loaded controlnet weights from %s", ckpt)

    def encode_images(self, rgb: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
        """[B,3,H,W] in [0,1] -> scaled latents [B,4,h,w] (fp32)."""
        return self.vae.encode(rgb * 2.0 - 1.0, eps).float()

    def noise_pred(self, latents_noisy, t, text_embeddings, image_cond, scales, n_copies: int,
                   rows: Optional[torch.Tensor] = None):
        """Batched eps prediction on ``n_copies`` replicas of the latent, in
        blocks of B, or with the sample of each row given by ``rows``
        (``perp_neg_rows``)."""
        if rows is None:
            rows = torch.arange(latents_noisy.shape[0], device=t.device).repeat(n_copies)
        latent_in, t_in = latents_noisy[rows], t[rows]
        down = mid = None
        if image_cond is not None:
            for cnet, cond, scale in zip(self.controlnets, image_cond, scales):
                if cond.shape[0] != 1:
                    cond = cond[rows]
                d, m = cnet(latent_in, t_in, text_embeddings, cond, scale)
                if down is None:
                    down, mid = list(d), m
                else:
                    down = [a + b for a, b in zip(down, d)]
                    mid = mid + m
        return self.unet(latent_in, t_in, text_embeddings,
                         down_block_additional_residuals=down,
                         mid_block_additional_residual=mid)

    def _prep_condition(self, cond: torch.Tensor, want_channels: Optional[int] = None):
        """A condition at guidance resolution; one channel repeated to three
        for the depth ControlNets."""
        cfg = self.cfg
        if want_channels == 3 and cond.shape[1] == 1:
            cond = cond.repeat(1, 3, 1, 1)
        if cond.shape[2] != cfg.height or cond.shape[3] != cfg.width:
            cond = F.interpolate(cond, size=(cfg.height, cfg.width), mode="bilinear",
                                 align_corners=False, antialias=True)
        return cond

    def _image_conditions(self, condition_map: Optional[torch.Tensor],
                          rgb: Optional[torch.Tensor] = None) -> Optional[List[torch.Tensor]]:
        """condition_map [B,22,h,w] -> per control type, at guidance
        resolution. ``rgb`` is the rendered image [B,3,H,W], which the
        render-derived control types of the triple guidance read."""
        if condition_map is None:
            return None
        out = []
        for ct in self.cfg.control_types:
            if ct == "light":
                out.append(self._prep_condition(condition_map))
            elif ct == "depth":
                out.append(self._prep_condition(condition_map[:, 0:1], want_channels=3))
            elif ct == "normal":
                out.append(self._prep_condition(condition_map[:, 1:4]))
            else:
                raise ValueError(f"unsupported control type {ct}")
        return out

    def _controls(self, condition_map, rgb, step: int):
        """The ControlNets' conditions and scales at ``step`` (None and []
        without ControlNets). The conditions are built without gradient from
        ``rgb.detach()``: the noise prediction they feed runs under no_grad
        (the JAX package stop-gradients it), so no gradient could reach
        ``rgb`` through a condition."""
        if not self.cfg.use_controlnet:
            return None, []
        with torch.no_grad():
            image_cond = self._image_conditions(condition_map, rgb=rgb.detach())
        return image_cond, self.condition_scales_at(step)

    def _timesteps(self, B: int, step: int, draws):
        """(t [B], min_step, max_step): t uniform over the scheduled window,
        from the ``t`` draw."""
        cfg = self.cfg
        T = self.num_train_timesteps
        min_step = int(round(T * C(cfg.min_step_percent, step)))
        max_step = int(round(T * C(cfg.max_step_percent, step)))
        u = draws.uniform("t", (B,))
        t = (min_step + u * float(max_step - min_step + 1)).to(torch.int64)
        return torch.clamp(t, 0, T - 1), min_step, max_step

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
        B = rgb.shape[0]
        f = self.vae_factor
        lat_shape = (B, self.vae_cfg.latent_channels, rgb.shape[2] // f, rgb.shape[3] // f)
        latents = self.encode_images(rgb, draws.normal("vae_eps", lat_shape))

        t, min_step, max_step = self._timesteps(B, step, draws)
        noise = draws.normal("noise", tuple(latents.shape))
        latents_noisy = add_noise(self.schedule, latents, noise, t)

        image_cond, scales = self._controls(condition_map, rgb, step)
        eps_perpneg = None
        if prompt_utils.use_perp_neg:
            text_embeddings, neg_w = prompt_utils.get_text_embeddings_perp_neg(
                elevation, azimuth, camera_distances)
            with torch.no_grad():
                eps = self.noise_pred(latents_noisy.detach(), t, text_embeddings, image_cond,
                                      scales, 5, rows=perp_neg_rows(B, True, t.device))
            eps_text, eps_uncond = eps[:B], eps[B:2 * B]
            eps_neg, eps_null = eps[2 * B:4 * B], eps[4 * B:]
            e_pos = eps_text - eps_uncond
            eps_perpneg = torch.zeros_like(e_pos)
            for i in range(2):
                # the negatives are interleaved per sample: [n0(b0), n1(b0), n0(b1), ...]
                eps_perpneg = eps_perpneg + neg_w[:, i].reshape(-1, 1, 1, 1) * \
                    perpendicular_component(eps_neg[i::2] - eps_uncond, e_pos)
        else:
            text_embeddings = prompt_utils.get_text_embeddings(
                elevation, azimuth, camera_distances,
                view_dependent_prompting=cfg.view_dependent_prompting)
            with torch.no_grad():
                eps = self.noise_pred(latents_noisy.detach(), t, text_embeddings, image_cond,
                                      scales, 3)
            eps_text, eps_uncond, eps_null = eps.chunk(3, dim=0)

        w = (1.0 - self.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1)
        grad = w * (C(cfg.cond_scale, step) * eps_text + C(cfg.uncond_scale, step) * eps_uncond
                    + C(cfg.null_scale, step) * eps_null + C(cfg.noise_scale, step) * noise)
        if eps_perpneg is not None:
            grad = grad + w * C(cfg.perpneg_scale, step) * eps_perpneg
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
