"""DeepFloyd IF guidance: SDS in pixel space at 64 x 64.

Counterpart of ``dreammat_tpu/models/guidance_deepfloyd.py``: no VAE, the
render resized to ``resolution`` and mapped to [-1, 1] is the diffusion
variable; the UNet (``if_like_unet_config``: SD2.1's blocks with 3
channels in, 6 out, of which only the eps half is used, and T5-XXL's
4096-d context) runs on the CFG replicas under ``torch.no_grad()``; the
schedule is ``squaredcos_cap_v2``; w(t) is ``sds`` (1 - a), ``uniform`` or
``fantasia3d`` (sqrt(a) (1 - a)):

    plain     eps_cfg = eps_text + g (eps_text - eps_uncond)
    Perp-Neg  eps_cfg = eps_uncond + g (e_pos + sum_i w_i perp(eps_neg_i - eps_uncond, e_pos))
    grad      = nan_to_num(w(t) (eps_cfg - noise)), clipped at ``grad_clip``
    loss_sds  = 0.5 ||x - stopgrad(x - grad)||^2 / B

With Perp-Neg the prompt embeddings interleave the two negatives per
sample ([n0(b0), n1(b0), n0(b1), ...]); this guidance runs each on its own
sample's latent (``perp_neg_rows``) and reads them so, ``eps_neg[i::2]``.
The JAX guidance replicates the latents in blocks and reads
``eps_neg[i*B:(i+1)*B]``, which pairs sample b with other samples'
negatives and latents when B > 1 (ROADMAP, queue 3); at B = 1 the two
agree. The draws are ``t`` and ``noise``. Weights: random-initialized, then
the UNet from ``cache_dir/unet`` where it holds a checkpoint;
``half_precision_weights`` stores them in bf16.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.convert import build_on, load_model_dir, random_init_
from dreammat_tpu_torch.models.diffusion.scheduler import SchedulerConfig, add_noise, make_schedule
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.detectors import resize_linear
from dreammat_tpu_torch.models.guidance import perp_neg_rows
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import perpendicular_component
from dreammat_tpu_torch.utils.schedule import C


def if_like_unet_config() -> UNetConfig:
    """IF-I-XL's widths on SD2.1's blocks: 3-channel pixels in, 6 channels
    out (eps and variance), T5-XXL context (4096)."""
    return replace(UNetConfig.sd21(), in_channels=3, out_channels=6, cross_attention_dim=4096,
                   use_linear_projection=False)


@dreammat_tpu_torch.register("deep-floyd-guidance")
class DeepFloydGuidance(BaseObject):
    @dataclass
    class Config:
        pretrained_model_name_or_path: str = "DeepFloyd/IF-I-XL-v1.0"
        cache_dir: Optional[str] = "model/deepfloyd"
        guidance_scale: float = 20.0
        grad_clip: Optional[Any] = None
        half_precision_weights: bool = True
        min_step_percent: Any = 0.02
        max_step_percent: Any = 0.98
        weighting_strategy: str = "sds"
        view_dependent_prompting: bool = True
        model_size: str = "if"  # "if" | "tiny"
        resolution: int = 64
        enable_memory_efficient_attention: bool = False
        enable_sequential_cpu_offload: bool = False
        enable_attention_slicing: bool = False
        enable_channels_last_format: bool = True
        max_items_eval: int = 4

    cfg: Config

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.half_precision_weights else torch.float32
        self.unet_cfg = (replace(UNetConfig.tiny(), in_channels=3, out_channels=6)
                         if cfg.model_size == "tiny" else if_like_unet_config())
        sc = SchedulerConfig(beta_schedule="squaredcos_cap_v2")
        self.schedule = make_schedule(sc, device=self.device)
        self.num_train_timesteps = sc.num_train_timesteps
        self.unet = None

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Random-initialize the UNet on the device, then load it from
        ``cache_dir/unet`` where that holds a checkpoint."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        unet = build_on(lambda: UNet2DCondition(self.unet_cfg), self.device, self.dtype)
        self.unet = random_init_(unet, generator).eval().requires_grad_(False)
        self.loaded = {}
        if self.cfg.cache_dir:
            report = load_model_dir(self.unet, os.path.join(str(self.cfg.cache_dir), "unet"),
                                    "unet")
            if report is not None:
                self.loaded["unet"] = report

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

    def _eps(self, x, t, emb, rows: torch.Tensor) -> torch.Tensor:
        """The eps half of the UNet's output on the CFG replicas, row i on
        sample ``rows[i]``."""
        return self.unet(x[rows], t[rows], emb)[:, :3]

    def __call__(self, rgb: torch.Tensor, prompt_utils, elevation, azimuth, camera_distances,
                 condition_map=None, step: int = 0, draws=None,
                 rgb_as_latents: bool = False) -> Dict[str, torch.Tensor]:
        """rgb [B,3,H,W] in [0,1]."""
        cfg = self.cfg
        if rgb_as_latents:
            raise ValueError("deep-floyd-guidance has no latent space")
        B, R, T = rgb.shape[0], cfg.resolution, self.num_train_timesteps
        x = resize_linear(rgb, (R, R)) * 2.0 - 1.0
        min_step = int(round(T * C(cfg.min_step_percent, step)))
        max_step = int(round(T * C(cfg.max_step_percent, step)))
        u = draws.uniform("t", (B,)).to(self.device)
        t = torch.clamp((min_step + u * float(max_step - min_step + 1)).to(torch.int64), 0, T - 1)
        noise = draws.normal("noise", tuple(x.shape)).to(self.device)
        x_noisy = add_noise(self.schedule, x, noise, t).detach()
        g = cfg.guidance_scale
        if prompt_utils.use_perp_neg:
            emb, neg_w = prompt_utils.get_text_embeddings_perp_neg(
                elevation, azimuth, camera_distances, return_null=False)
            with torch.no_grad():
                eps = self._eps(x_noisy, t, emb, perp_neg_rows(B, False, t.device))
            eps_text, eps_uncond, eps_neg = eps[:B], eps[B:2 * B], eps[2 * B:]
            e_pos = eps_text - eps_uncond
            accum = torch.zeros_like(e_pos)
            for i in range(2):
                accum = accum + neg_w[:, i].reshape(-1, 1, 1, 1) * \
                    perpendicular_component(eps_neg[i::2] - eps_uncond, e_pos)
            eps_cfg = eps_uncond + g * (e_pos + accum)
        else:
            emb = prompt_utils.get_text_embeddings(
                elevation, azimuth, camera_distances,
                view_dependent_prompting=cfg.view_dependent_prompting, return_null=False)
            with torch.no_grad():
                rows = torch.arange(B, device=t.device).repeat(2)
                eps_text, eps_uncond = self._eps(x_noisy, t, emb, rows).chunk(2)
            # IF's high-scale CFG anchors on the text branch
            eps_cfg = eps_text + g * (eps_text - eps_uncond)
        grad = torch.nan_to_num(self._weight(t) * (eps_cfg - noise))
        if cfg.grad_clip is not None:
            clip = C(cfg.grad_clip, step)
            grad = torch.clamp(grad, -clip, clip)
        target = (x - grad).detach()
        return {"loss_sds": 0.5 * torch.sum((x - target) ** 2) / B,
                "grad_norm": torch.linalg.norm(grad.detach()),
                "min_step": min_step, "max_step": max_step}
