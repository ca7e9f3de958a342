"""Variational Score Distillation guidance (ProlificDreamer).

Counterpart of ``stable-diffusion-vsd-guidance`` in
``dreammat_tpu/models/guidance_vsd.py``. One SD UNet serves both branches:
the pretrained one as it is, the LoRA one with its attention projections
merged with the LoRA factors (``diffusion/lora.py``) and the camera fed to
its class-embedding slot, all through ``torch.func.functional_call``:

    eps_pretrain = eps_uncond + g (eps_text - eps_uncond)   view-dependent prompts
    eps_est      = eps_unc + g_lora (eps_cam - eps_unc)     camera, or zeros
    grad         = (1 - a_t) (eps_pretrain - eps_est)
    loss_vsd     = 0.5 ||latents - stopgrad(latents - grad)||^2 / B
    loss_lora    = mean((eps_lora(x_t2, t2, y, cam) - noise2)^2)

Both CFG passes run under ``torch.no_grad()``; ``loss_lora`` regresses the
LoRA branch on the detached latents at fresh timesteps, so its gradient
reaches only the LoRA factors and the camera embedding (backpropagated
through the whole UNet: kernels C and D on the card), and ``loss_vsd``
reaches only the render. The trainable LoRA state (``init_lora``) is a
``LoRAState`` module that the system owns and optimizes. The draws are
``vae_eps``, ``t``, ``noise``, ``t2`` (integers in [0, T)), ``noise2``
and, with ``lora_cfg_training``, ``camera_drop`` (uniform [B,1] < 0.1
zeroes that sample's camera). Unlike the JAX guidance, no ``loss_sds``
alias of ``loss_vsd`` is returned: a system that weighs every ``loss_*``
would count it twice (ROADMAP, queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion import layers as L
from dreammat_tpu_torch.models.diffusion import lora as lora_lib
from dreammat_tpu_torch.models.diffusion.scheduler import add_noise
from dreammat_tpu_torch.models.guidance_sds import StableDiffusionGuidance

CAMERA_DIM = 16  # a flattened 4x4 c2w


class LoRAState(nn.Module):
    """The VSD guidance's trainable state: the LoRA factors of every site
    (``layers``) and the camera embedding (``camera_embedding``, a
    ``TimestepEmbedding(16 -> 4 ch0)``), both fp32."""

    def __init__(self, layers: lora_lib.LoRALayers, camera_embedding: nn.Module):
        super().__init__()
        self.layers = layers
        self.camera_embedding = camera_embedding


def new_lora_state(unet: nn.Module, rank: int, camera_dim: int, temb_dim: int,
                   generator: torch.Generator, device) -> LoRAState:
    """LoRA factors for every site of ``unet`` (``init_lora_params``, seeded
    from ``generator``) and a ``TimestepEmbedding(camera_dim -> temb_dim)``
    with normal(0, 1/sqrt(fan_in)) weights and zero biases, fp32 on
    ``device``."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device).item())
    layers = lora_lib.init_lora_params(unet, rank, seed=seed)
    cam = L.TimestepEmbedding(camera_dim, temb_dim).to(device)
    with torch.no_grad():
        for lin in (cam.linear_1, cam.linear_2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator,
                                         device=device) / math.sqrt(lin.in_features))
            lin.bias.zero_()
    return LoRAState(layers, cam)


def merged_unet_params(unet: nn.Module, lora: LoRAState,
                       dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The UNet's tensors that the LoRA branch replaces: every site's merged
    weight and the camera embedding in the class-embedding slot (cast to
    ``dtype``). Differentiable in ``lora``."""
    merged = lora_lib.merge_lora(unet, lora.layers, 1.0)
    for name, p in lora.camera_embedding.named_parameters():
        merged["class_embedding." + name] = p.to(dtype)
    return merged


@dreammat_tpu_torch.register("stable-diffusion-vsd-guidance")
class StableDiffusionVSDGuidance(StableDiffusionGuidance):
    @dataclass
    class Config(StableDiffusionGuidance.Config):
        use_controlnet: bool = False
        guidance_scale: float = 7.5
        guidance_scale_lora: float = 1.0
        lora_rank: int = 4
        lora_cfg_training: bool = True
        lora_n_timestamp_samples: int = 1
        camera_condition_type: str = "extrinsics"  # | "mvp" (not supported)

    cfg: Config
    unet_class_embed_dim = CAMERA_DIM

    def init_lora(self, generator: torch.Generator) -> LoRAState:
        """Fresh LoRA factors (``init_lora_params``, seeded from
        ``generator``) and a camera embedding (normal(0, 1/sqrt(fan_in))
        weights, zero biases), fp32 on the guidance's device."""
        assert self.unet is not None, "init_params first"
        state = new_lora_state(self.unet, self.cfg.lora_rank, CAMERA_DIM,
                               self.unet_cfg.block_out_channels[0] * 4, generator, self.device)
        dreammat_tpu_torch.info("VSD lora: %d sites, %d params (rank %d) + camera embedding",
                                len(state.layers.sites), lora_lib.lora_param_count(state.layers),
                                self.cfg.lora_rank)
        return state

    def merged_unet_params(self, lora: LoRAState) -> Dict[str, torch.Tensor]:
        return merged_unet_params(self.unet, lora, self.dtype)

    def lora_eps(self, merged: Dict[str, torch.Tensor], latents, t, emb, cam) -> torch.Tensor:
        """One LoRA-branch eps prediction, conditioned on the camera."""
        return functional_call(self.unet, merged, (latents, t, emb), {"class_labels": cam})

    def __call__(self, rgb: torch.Tensor, prompt_utils, elevation, azimuth, camera_distances,
                 c2w: torch.Tensor, lora: LoRAState, step: int, draws,
                 rgb_as_latents: bool = False) -> Dict[str, torch.Tensor]:
        """rgb [B,3,H,W] in [0,1] (or [B,4,H,W] latents with
        ``rgb_as_latents``), c2w [B,4,4], ``lora`` the trainable state."""
        cfg = self.cfg
        if cfg.camera_condition_type != "extrinsics":
            raise NotImplementedError("only camera_condition_type=extrinsics is supported "
                                      "(mvp needs the projection matrix in the batch)")
        B = rgb.shape[0]
        f = self.vae_factor
        if rgb_as_latents:
            lh = rgb.shape[2] // f
            latents = F.interpolate(rgb, size=(lh, lh), mode="bilinear", align_corners=False,
                                    antialias=True)
        else:
            lat_shape = (B, self.vae_cfg.latent_channels, rgb.shape[2] // f, rgb.shape[3] // f)
            latents = self.encode_images(rgb, draws.normal("vae_eps", lat_shape))
        t, min_step, max_step = self._timesteps(B, step, draws)
        noise = draws.normal("noise", tuple(latents.shape))
        latents_noisy = add_noise(self.schedule, latents, noise, t).detach()
        cam = c2w.reshape(B, CAMERA_DIM).float()
        merged = self.merged_unet_params(lora)

        # the pretrained branch: view-dependent prompts, diffusers' CFG
        emb_vd = prompt_utils.get_text_embeddings(
            elevation, azimuth, camera_distances,
            view_dependent_prompting=cfg.view_dependent_prompting, return_null=False)
        # the LoRA branch: the view-independent prompt, CFG over the camera
        emb_cond = prompt_utils.get_text_embeddings(
            elevation, azimuth, camera_distances, view_dependent_prompting=False,
            return_null=False)[:B]
        with torch.no_grad():
            eps_text, eps_uncond = self.noise_pred(latents_noisy, t, emb_vd, None, [], 2).chunk(2)
            eps_cam, eps_unc = self.lora_eps(
                merged, torch.cat([latents_noisy] * 2), torch.cat([t] * 2),
                torch.cat([emb_cond] * 2), torch.cat([cam, torch.zeros_like(cam)])).chunk(2)
        eps_pretrain = eps_uncond + cfg.guidance_scale * (eps_text - eps_uncond)
        eps_est = eps_unc + cfg.guidance_scale_lora * (eps_cam - eps_unc)
        w = (1.0 - self.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1)
        grad = torch.nan_to_num(w * (eps_pretrain - eps_est))
        if cfg.grad_clip_val is not None:
            grad = torch.clamp(grad, -cfg.grad_clip_val, cfg.grad_clip_val)
        target = (latents - grad).detach()
        loss_vsd = 0.5 * torch.sum((latents - target) ** 2) / B

        # the LoRA regression on the current render distribution
        n_ts = cfg.lora_n_timestamp_samples
        lat_d = latents.detach().repeat(n_ts, 1, 1, 1)
        t2 = draws.integers("t2", 0, self.num_train_timesteps, (B * n_ts,)).to(self.device)
        noise2 = draws.normal("noise2", tuple(lat_d.shape)).to(self.device)
        noisy2 = add_noise(self.schedule, lat_d, noise2, t2)
        cam_l = cam
        if cfg.lora_cfg_training:
            drop = draws.uniform("camera_drop", (B, 1)).to(self.device) < 0.1
            cam_l = torch.where(drop, torch.zeros_like(cam), cam)
        eps_pred = self.lora_eps(merged, noisy2, t2, emb_cond.repeat(n_ts, 1, 1),
                                 cam_l.repeat(n_ts, 1))
        loss_lora = torch.mean((eps_pred.float() - noise2) ** 2)
        return {
            "loss_vsd": loss_vsd,
            "loss_lora": loss_lora,
            "grad_norm": torch.linalg.norm(grad.detach()),
            "min_step": min_step,
            "max_step": max_step,
        }
