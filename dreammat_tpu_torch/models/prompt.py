"""Prompt processing: view-dependent prompts and cached CLIP text embeddings.

Counterpart of ``dreammat_tpu/models/prompt.py``: the four direction
buckets (side / front / back / overhead, later conditions override), the
text / uncond / null embeddings, the Perp-Neg embeddings and weights
(``get_text_embeddings_perp_neg``), ``lib:`` prompts resolved through the
prompt library JSON, CLIP loaded from ``pretrained_model_cache_dir/
text_encoder`` when it holds a checkpoint (random weights otherwise), and
the md5-keyed on-disk embedding cache: one ``<md5>.npy`` of float32 [N, D]
per prompt under ``cache_dir``, with the JAX package's key, so the two
packages share one cache directory. With ``use_prompt_debiasing`` the
four direction prompts are formatted from the BERT-PMI debiased prompts
(``models/debias.py``; BERT-base at full width, tiny otherwise,
from ``pretrained_model_name_or_path_prompt_debiasing`` where it holds a
checkpoint, random weights otherwise); manual view prompts are refused
then.

``model_size`` picks the text tower: ``sd21`` (OpenCLIP ViT-H, 1024 wide),
``ip2p`` (InstructPix2Pix's ViT-L/14, 768 wide, which the IP2P guidance's
UNet attends to) or ``tiny``. The ``ip2p`` cache key names the width too:
the JAX package's ``ip2p`` embeddings are its tiny tower's.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
from dreammat_tpu_torch.models.diffusion.convert import build_on, load_model_dir, random_init_
from dreammat_tpu_torch.models.diffusion.tokenizer import CLIPTokenizer
from dreammat_tpu_torch.parallel import distributed as dist
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


def shift_azimuth_deg(azimuth):
    return torch.remainder(azimuth + 180.0, 360.0) - 180.0


def shifted_exponential_decay(a, b, c, r):
    return a * torch.exp(-b * r) + c


class PromptEmbeddings(NamedTuple):
    text_vd: torch.Tensor    # [4, N, D] per-direction prompt embeddings
    uncond_vd: torch.Tensor  # [4, N, D]
    text: torch.Tensor       # [N, D]
    uncond: torch.Tensor     # [N, D]
    null: torch.Tensor       # [N, D]
    use_perp_neg: bool = False
    perp_neg_f_sb: Tuple[float, float, float] = (1, 0.5, -0.606)
    perp_neg_f_fsb: Tuple[float, float, float] = (1, 0.5, +0.967)
    perp_neg_f_fs: Tuple[float, float, float] = (4, 0.5, -2.426)
    perp_neg_f_sf: Tuple[float, float, float] = (4, 0.5, -2.426)

    def direction_idx(self, elevation, azimuth, overhead_th=60.0, front_th=45.0, back_th=45.0):
        """0 = side, 1 = front, 2 = back, 3 = overhead."""
        azi = shift_azimuth_deg(azimuth)
        idx = torch.zeros_like(elevation, dtype=torch.long)
        idx = torch.where((azi > -front_th) & (azi < front_th), torch.ones_like(idx), idx)
        idx = torch.where((azi > 180 - back_th) | (azi < -180 + back_th), torch.full_like(idx, 2), idx)
        return torch.where(elevation > overhead_th, torch.full_like(idx, 3), idx)

    def get_text_embeddings(self, elevation, azimuth, camera_distances,
                            view_dependent_prompting: bool = True,
                            return_null: bool = True) -> torch.Tensor:
        """[3B, N, D]: text, uncond, null (cond first); [2B, N, D] without
        the null rows."""
        B = elevation.shape[0]
        if view_dependent_prompting:
            d = self.direction_idx(elevation, azimuth)
            text, uncond = self.text_vd[d], self.uncond_vd[d]
        else:
            text = self.text[None].expand(B, *self.text.shape)
            uncond = self.uncond[None].expand(B, *self.uncond.shape)
        if not return_null:
            return torch.cat([text, uncond], dim=0)
        null = self.null[None].expand(B, *self.null.shape)
        return torch.cat([text, uncond, null], dim=0)

    def get_text_embeddings_perp_neg(self, elevation, azimuth, camera_distances,
                                     return_null: bool = True):
        """([5B, N, D], [B, 2]): the positive (interpolated between the
        neighbouring direction prompts), uncond, the two negatives
        interleaved per sample ([n0(b0), n1(b0), n0(b1), ...]) and null
        ([4B, N, D] without it); and the negatives' guidance weights (0
        overhead)."""
        B = elevation.shape[0]
        d = self.direction_idx(elevation, azimuth)
        azi = shift_azimuth_deg(azimuth)
        side, front, back, overhead = (self.text_vd[i] for i in range(4))
        col = lambda x: x[:, None, None]
        is_overhead = col(d == 3)
        front_side = azi.abs() < 90.0
        r_fs = 1.0 - azi.abs() / 90.0
        r_sb = 2.0 - azi.abs() / 90.0

        pos_fs = col(r_fs) * front[None] + col(1 - r_fs) * side[None]
        pos_sb = col(r_sb) * side[None] + col(1 - r_sb) * back[None]
        pos = torch.where(col(front_side), pos_fs, pos_sb)
        pos = torch.where(is_overhead, overhead[None], pos)

        uncond = self.uncond_vd[d]
        neg0 = torch.where(col(front_side), front[None], side[None])
        neg1 = torch.where(col(front_side), side[None], front[None])
        neg0 = torch.where(is_overhead, uncond, neg0)
        neg1 = torch.where(is_overhead, uncond, neg1)

        w0 = torch.where(front_side, -shifted_exponential_decay(*self.perp_neg_f_fs, r_fs),
                         -shifted_exponential_decay(*self.perp_neg_f_sb, r_sb))
        w1 = torch.where(front_side, -shifted_exponential_decay(*self.perp_neg_f_sf, 1 - r_fs),
                         -shifted_exponential_decay(*self.perp_neg_f_fsb, r_sb))
        w0 = torch.where(d == 3, torch.zeros_like(w0), w0)
        w1 = torch.where(d == 3, torch.zeros_like(w1), w1)

        negs = torch.stack([neg0, neg1], dim=1).reshape(2 * B, *neg0.shape[1:])
        parts = [pos, uncond, negs]
        if return_null:
            parts.append(self.null[None].expand(B, *self.null.shape))
        return torch.cat(parts, dim=0), torch.stack([w0, w1], dim=-1)


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
        pretrained_model_name_or_path_prompt_debiasing: str = "model/bert-base-uncased"
        prompt_debiasing_mask_ids: Optional[List[int]] = None
        prompt_library_path: str = "load/prompt_library.json"
        model_size: str = "sd21"

    cfg: Config

    def preprocess_prompt(self, prompt: str) -> str:
        """``lib:key`` resolves to the first collection of the prompt
        library JSON that holds ``key``."""
        if not prompt.startswith("lib:"):
            return prompt
        with open(self.cfg.prompt_library_path) as f:
            library = json.load(f)
        key = prompt[4:]
        for collection in library.values():
            if isinstance(collection, dict) and key in collection:
                return collection[key]
        raise ValueError(f"prompt '{key}' not found in the prompt library")

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        if cfg.view_dependent_prompt_front:
            fmt = ["side view of {}", "front view of {}", "backside view of {}", "overhead view of {}"]
        else:
            fmt = ["{}, side view", "{}, front view", "{}, back view", "{}, overhead view"]
        self.prompt = self.preprocess_prompt(cfg.prompt)
        self.debiased: Optional[List[str]] = None
        if cfg.use_prompt_debiasing:
            assert (cfg.prompt_side is None and cfg.prompt_back is None
                    and cfg.prompt_overhead is None), \
                "Do not manually assign view prompts when using prompt debiasing"
            from dreammat_tpu_torch.models.debias import build_bert_mlm, get_debiased_prompt

            mlm_fn, tok, _ = build_bert_mlm(
                cfg.pretrained_model_name_or_path_prompt_debiasing,
                size="tiny" if self.clip_config() == CLIPTextConfig.tiny() else "base",
                device=self.device)
            self.debiased = get_debiased_prompt(self.prompt, mlm_fn, tok,
                                                mask_ids=cfg.prompt_debiasing_mask_ids)
            self.prompts_vd = [f.format(p) for f, p in zip(fmt, self.debiased)]
        else:
            manual = [cfg.prompt_side, cfg.prompt_front, cfg.prompt_back, cfg.prompt_overhead]
            self.prompts_vd = [m if m is not None else f.format(self.prompt)
                               for m, f in zip(manual, fmt)]
        self.negative_prompts_vd = [cfg.negative_prompt] * 4
        self.text_encoder: Optional[CLIPTextModel] = None
        self.loaded = None  # the CLIP load's report, when a checkpoint was found
        self.cache_hits = 0
        self._emb: Optional[PromptEmbeddings] = None

    def clip_config(self) -> CLIPTextConfig:
        """The text tower of ``model_size`` (any other value: tiny)."""
        return {"sd21": CLIPTextConfig.sd21, "ip2p": CLIPTextConfig.ip2p}.get(
            self.cfg.model_size, CLIPTextConfig.tiny)()

    def get_encoder(self, generator: Optional[torch.Generator] = None):
        """(model, tokenizer); on first use the model is random-initialized,
        then loaded from ``pretrained_model_cache_dir/text_encoder`` where
        that holds a checkpoint."""
        ccfg = self.clip_config()
        if self.text_encoder is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            model = build_on(lambda: CLIPTextModel(ccfg), self.device, torch.float32)
            model = random_init_(model, generator).eval().requires_grad_(False)
            self.loaded = load_model_dir(
                model, os.path.join(self.cfg.pretrained_model_cache_dir, "text_encoder"), "clip")
            self.text_encoder = model
        tok = CLIPTokenizer(
            vocab_dir=os.path.join(self.cfg.pretrained_model_cache_dir, "tokenizer"),
            max_length=ccfg.max_length, vocab_size=ccfg.vocab_size,
        )
        return self.text_encoder, tok

    def _cache_key(self, prompt: str) -> str:
        """The JAX package's key; ``ip2p`` names its width as well, since the
        JAX package's ``ip2p`` is its tiny tower and writes 64-wide files."""
        size = self.cfg.model_size
        if size == "ip2p":
            size = f"{size}{self.clip_config().hidden_size}"
        ident = f"{self.cfg.pretrained_model_name_or_path}-{size}-{prompt}"
        return hashlib.md5(ident.encode()).hexdigest()

    def encode_prompts(self, prompts: List[str]) -> torch.Tensor:
        """[len(prompts), N, D] float32 on the device: cached ``.npy`` files
        where they exist (with ``use_cache``), the rest encoded and written.
        Under a process group rank 0 encodes and writes what the shared cache
        lacks while the others wait at a barrier, then they read it (the JAX
        package's rank-0 fill, ``prompt.py:244-262``)."""
        with dist.rank_zero_first("text_embeddings") if self.cfg.use_cache \
                else contextlib.nullcontext():
            return self._encode_with_cache(prompts)

    def _encode_with_cache(self, prompts: List[str]) -> torch.Tensor:
        cfg = self.cfg
        out: List[Optional[np.ndarray]] = [None] * len(prompts)
        paths = [os.path.join(cfg.cache_dir, self._cache_key(p) + ".npy") for p in prompts]
        if cfg.use_cache:
            for i, path in enumerate(paths):
                if os.path.exists(path):
                    out[i] = np.load(path)
                    self.cache_hits += 1
        todo = [i for i, x in enumerate(out) if x is None]
        if todo:
            emb = self._encode_uncached([prompts[i] for i in todo])
            if cfg.use_cache:
                os.makedirs(cfg.cache_dir, exist_ok=True)
            for j, i in enumerate(todo):
                out[i] = emb[j]
                if cfg.use_cache:
                    # written beside and renamed, so a reader never sees half a file
                    tmp = f"{paths[i]}.{os.getpid()}.tmp.npy"
                    np.save(tmp, emb[j])
                    os.replace(tmp, paths[i])
        if cfg.use_cache:
            dreammat_tpu_torch.info("prompt embeddings: %d of %d from the cache %s",
                                    len(prompts) - len(todo), len(prompts), cfg.cache_dir)
        return torch.as_tensor(np.stack(out), device=self.device)

    @torch.no_grad()
    def _encode_uncached(self, prompts: List[str]) -> np.ndarray:
        model, tok = self.get_encoder()
        ids = torch.as_tensor(tok.batch(prompts), dtype=torch.long, device=self.device)
        return model(ids).float().cpu().numpy()

    def __call__(self) -> PromptEmbeddings:
        if self._emb is None:
            cfg = self.cfg
            emb = self.encode_prompts(
                [self.prompt, cfg.negative_prompt, ""] + self.prompts_vd + self.negative_prompts_vd)
            self._emb = PromptEmbeddings(
                text=emb[0], uncond=emb[1], null=emb[2], text_vd=emb[3:7], uncond_vd=emb[7:11],
                use_perp_neg=cfg.use_perp_neg, perp_neg_f_sb=tuple(cfg.perp_neg_f_sb),
                perp_neg_f_fsb=tuple(cfg.perp_neg_f_fsb), perp_neg_f_fs=tuple(cfg.perp_neg_f_fs),
                perp_neg_f_sf=tuple(cfg.perp_neg_f_sf))
        return self._emb
