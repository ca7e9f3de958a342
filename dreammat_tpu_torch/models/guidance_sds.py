"""Plain Stable-Diffusion SDS guidance (no ControlNet by default).

Counterpart of ``dreammat_tpu/models/guidance_sds.py``. It shares the whole
diffusion stack (UNet, VAE, scheduler, optional ControlNets) with the
DreamMat guidance by subclassing it; only the estimator and the number of
replicas differ:

    eps_cfg = eps_text + g (eps_text - eps_uncond)     (text-anchored CFG)
    grad    = w(t) (eps_cfg - noise)
    w(t)    = 1 - a  ("sds") | 1 ("uniform") | sqrt(a) (1 - a) ("fantasia3d")

with a = alphas_cumprod[t], two replicas (text, uncond), or four with
Perp-Neg (text, uncond and the two negatives, which the prompt embeddings
interleave per sample: eps_neg[i::2] is negative i of every sample, each
run on its own sample's latent, ``perp_neg_rows``).

``use_sjc`` switches to Score Jacobian Chaining: sigma = sqrt((1-a)/a), the
latent is perturbed additively (z = y + sigma n, scaled by 1/sqrt(1+sigma^2)
before the UNet), D = z - sigma eps_cfg and grad = -(D - y)/sigma
(``var_red``) or -(D - z)/sigma. ``rgb_as_latents`` takes a 4-channel
latent image and resizes it to latent resolution (antialiased when it
shrinks, as ``jax.image.resize`` is) instead of encoding it.

The draws are ``vae_eps`` (not drawn with ``rgb_as_latents``), ``t`` and
``noise``; SJC perturbs with the same ``noise``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.scheduler import add_noise
from dreammat_tpu_torch.models.guidance import StableDiffusionLightGuidance, perp_neg_rows
from dreammat_tpu_torch.utils.ops import perpendicular_component


@dreammat_tpu_torch.register("stable-diffusion-guidance")
class StableDiffusionGuidance(StableDiffusionLightGuidance):
    @dataclass
    class Config(StableDiffusionLightGuidance.Config):
        use_controlnet: bool = False
        guidance_scale: float = 100.0
        weighting_strategy: str = "sds"  # "sds" | "uniform" | "fantasia3d"
        use_sjc: bool = False
        var_red: bool = True

    cfg: Config

    def _weight(self, t: torch.Tensor) -> torch.Tensor:
        a = self.schedule["alphas_cumprod"][t].reshape(-1, 1, 1, 1)
        ws = self.cfg.weighting_strategy
        if ws == "sds":
            return 1.0 - a
        if ws == "uniform":
            return torch.ones_like(a)
        if ws == "fantasia3d":
            return torch.sqrt(a) * (1.0 - a)
        raise ValueError(f"Unknown weighting strategy: {ws}")

    def __call__(self, rgb: torch.Tensor, prompt_utils, elevation, azimuth, camera_distances,
                 condition_map: Optional[torch.Tensor], step: int, draws,
                 rgb_as_latents: bool = False) -> Dict[str, torch.Tensor]:
        """rgb [B,3,H,W] in [0,1] (or [B,4,H,W] latents with
        ``rgb_as_latents``); condition_map [B,C,h,w] (channel 0 depth, 1:4
        normal) feeds the optional depth and normal ControlNets."""
        cfg = self.cfg
        B = rgb.shape[0]
        f = self.vae_factor
        if rgb_as_latents:
            if rgb.shape[1] != 4:
                raise ValueError(f"rgb_as_latents expects 4 channels, got {tuple(rgb.shape)}")
            lh = rgb.shape[2] // f
            latents = F.interpolate(rgb, size=(lh, lh), mode="bilinear", align_corners=False,
                                    antialias=True)
        else:
            lat_shape = (B, self.vae_cfg.latent_channels, rgb.shape[2] // f, rgb.shape[3] // f)
            latents = self.encode_images(rgb, draws.normal("vae_eps", lat_shape))

        t, min_step, max_step = self._timesteps(B, step, draws)
        noise = draws.normal("noise", tuple(latents.shape))
        if cfg.use_sjc:
            # the variance-exploding perturbation, scaled to the VP frame
            a = self.schedule["alphas_cumprod"][t].reshape(-1, 1, 1, 1)
            sigma = torch.sqrt((1.0 - a) / a)
            zs = latents + sigma * noise
            latents_noisy = zs / torch.sqrt(1.0 + sigma ** 2)
        else:
            latents_noisy = add_noise(self.schedule, latents, noise, t)

        image_cond, scales = (self._controls(condition_map, rgb, step)
                              if condition_map is not None else (None, []))
        g = cfg.guidance_scale
        if prompt_utils.use_perp_neg:
            emb, neg_w = prompt_utils.get_text_embeddings_perp_neg(
                elevation, azimuth, camera_distances, return_null=False)
            with torch.no_grad():
                eps = self.noise_pred(latents_noisy.detach(), t, emb, image_cond, scales, 4,
                                      rows=perp_neg_rows(B, False, t.device))
            eps_text, eps_uncond, eps_neg = eps[:B], eps[B:2 * B], eps[2 * B:]
            e_pos = eps_text - eps_uncond
            accum = torch.zeros_like(e_pos)
            for i in range(2):
                # negatives interleaved per sample: [n0(b0), n1(b0), n0(b1), ...]
                accum = accum + neg_w[:, i].reshape(-1, 1, 1, 1) * \
                    perpendicular_component(eps_neg[i::2] - eps_uncond, e_pos)
            eps_cfg = eps_text + g * (e_pos + accum)
        else:
            emb = prompt_utils.get_text_embeddings(
                elevation, azimuth, camera_distances,
                view_dependent_prompting=cfg.view_dependent_prompting, return_null=False)
            with torch.no_grad():
                eps = self.noise_pred(latents_noisy.detach(), t, emb, image_cond, scales, 2)
            eps_text, eps_uncond = eps.chunk(2, dim=0)
            eps_cfg = eps_text + g * (eps_text - eps_uncond)

        if cfg.use_sjc:
            Ds = zs - sigma * eps_cfg
            anchor = latents if cfg.var_red else zs
            grad = -(Ds - anchor) / sigma
        else:
            grad = self._weight(t) * (eps_cfg - noise)
        grad = torch.nan_to_num(grad)
        if cfg.grad_clip_val is not None:
            grad = torch.clamp(grad, -cfg.grad_clip_val, cfg.grad_clip_val)
        target = (latents - grad).detach()
        loss_sds = 0.5 * torch.sum((latents - target) ** 2) / B
        return {
            "loss_sds": loss_sds,
            "grad_norm": torch.linalg.norm(grad.detach()),
            "min_step": min_step,
            "max_step": max_step,
        }
