"""Prompt processing: view-dependent prompts and CLIP text embeddings.

Counterpart of ``dreammat_tpu/models/prompt.py`` without Perp-Neg and
without the on-disk embedding cache (both later slices): the four direction
buckets (side / front / back / overhead, later conditions override) and the
text / uncond / null embeddings, computed once with the CLIP text encoder.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
from dreammat_tpu_torch.models.diffusion.convert import build_on, random_init_
from dreammat_tpu_torch.models.diffusion.tokenizer import CLIPTokenizer
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


class PromptEmbeddings(NamedTuple):
    text_vd: torch.Tensor    # [4, N, D] per-direction prompt embeddings
    uncond_vd: torch.Tensor  # [4, N, D]
    text: torch.Tensor       # [N, D]
    uncond: torch.Tensor     # [N, D]
    null: torch.Tensor       # [N, D]
    use_perp_neg: bool = False

    def direction_idx(self, elevation, azimuth, overhead_th=60.0, front_th=45.0, back_th=45.0):
        """0 = side, 1 = front, 2 = back, 3 = overhead."""
        azi = torch.remainder(azimuth + 180.0, 360.0) - 180.0
        idx = torch.zeros_like(elevation, dtype=torch.long)
        idx = torch.where((azi > -front_th) & (azi < front_th), torch.ones_like(idx), idx)
        idx = torch.where((azi > 180 - back_th) | (azi < -180 + back_th), torch.full_like(idx, 2), idx)
        return torch.where(elevation > overhead_th, torch.full_like(idx, 3), idx)

    def get_text_embeddings(self, elevation, azimuth, camera_distances,
                            view_dependent_prompting: bool = True) -> torch.Tensor:
        """[3B, N, D]: text, uncond, null (cond first)."""
        B = elevation.shape[0]
        if view_dependent_prompting:
            d = self.direction_idx(elevation, azimuth)
            text, uncond = self.text_vd[d], self.uncond_vd[d]
        else:
            text = self.text[None].expand(B, *self.text.shape)
            uncond = self.uncond[None].expand(B, *self.uncond.shape)
        null = self.null[None].expand(B, *self.null.shape)
        return torch.cat([text, uncond, null], dim=0)


@dreammat_tpu_torch.register("stable-diffusion-prompt-processor")
class StableDiffusionPromptProcessor(BaseObject):
    @dataclass
    class Config:
        prompt: str = "a hamburger"
        prompt_front: Optional[str] = None
        prompt_side: Optional[str] = None
        prompt_back: Optional[str] = None
        prompt_overhead: Optional[str] = None
        negative_prompt: str = ""
        pretrained_model_name_or_path: str = "stabilityai/stable-diffusion-2-1-base"
        pretrained_model_cache_dir: str = "model"
        overhead_threshold: float = 60.0
        front_threshold: float = 45.0
        back_threshold: float = 45.0
        view_dependent_prompt_front: bool = False
        use_cache: bool = True
        spawn: bool = True
        cache_dir: str = ".dreammat_tpu_cache/text_embeddings"
        use_perp_neg: bool = False
        perp_neg_f_sb: Tuple = (1, 0.5, -0.606)
        perp_neg_f_fsb: Tuple = (1, 0.5, +0.967)
        perp_neg_f_fs: Tuple = (4, 0.5, -2.426)
        perp_neg_f_sf: Tuple = (4, 0.5, -2.426)
        use_prompt_debiasing: bool = False
        model_size: str = "sd21"

    cfg: Config

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        if cfg.use_perp_neg or cfg.use_prompt_debiasing:
            raise NotImplementedError("Perp-Neg and prompt debiasing are not ported yet")
        if cfg.prompt.startswith("lib:"):
            raise NotImplementedError("prompt-library prompts are not ported yet")
        if cfg.view_dependent_prompt_front:
            fmt = ["side view of {}", "front view of {}", "backside view of {}", "overhead view of {}"]
        else:
            fmt = ["{}, side view", "{}, front view", "{}, back view", "{}, overhead view"]
        manual = [cfg.prompt_side, cfg.prompt_front, cfg.prompt_back, cfg.prompt_overhead]
        self.prompt = cfg.prompt
        self.prompts_vd = [m if m is not None else f.format(cfg.prompt) for m, f in zip(manual, fmt)]
        self.negative_prompts_vd = [cfg.negative_prompt] * 4
        self.text_encoder: Optional[CLIPTextModel] = None
        self._emb: Optional[PromptEmbeddings] = None
        if cfg.use_cache:
            dreammat_tpu_torch.warn("the prompt-embedding disk cache is not ported yet; "
                                    "embeddings are computed every run")

    def get_encoder(self, generator: Optional[torch.Generator] = None):
        """(model, tokenizer); the model is random-initialized on first use."""
        ccfg = CLIPTextConfig.sd21() if self.cfg.model_size == "sd21" else CLIPTextConfig.tiny()
        if self.text_encoder is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            model = build_on(lambda: CLIPTextModel(ccfg), self.device, torch.float32)
            self.text_encoder = random_init_(model, generator).eval().requires_grad_(False)
        tok = CLIPTokenizer(
            vocab_dir=os.path.join(self.cfg.pretrained_model_cache_dir, "tokenizer"),
            max_length=ccfg.max_length, vocab_size=ccfg.vocab_size,
        )
        return self.text_encoder, tok

    @torch.no_grad()
    def encode_prompts(self, prompts: List[str]) -> torch.Tensor:
        model, tok = self.get_encoder()
        ids = torch.as_tensor(tok.batch(prompts), dtype=torch.long, device=self.device)
        return model(ids).float()

    def __call__(self) -> PromptEmbeddings:
        if self._emb is None:
            cfg = self.cfg
            emb = self.encode_prompts(
                [self.prompt, cfg.negative_prompt, ""] + self.prompts_vd + self.negative_prompts_vd)
            self._emb = PromptEmbeddings(text=emb[0], uncond=emb[1], null=emb[2],
                                         text_vd=emb[3:7], uncond_vd=emb[7:11])
        return self._emb
