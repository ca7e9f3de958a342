"""Perceptual (VGG16-feature) distance for image supervision.

Counterpart of ``dreammat_tpu/utils/perceptual.py``: an LPIPS-style
distance over the VGG16 conv tower. Each image goes through the thirteen
3x3 convolutions (ReLU after each, a 2x2 max-pool before blocks 2-5, on
ImageNet-normalised input); at the taps relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3 the activations are unit-normalised along channels
(``a / sqrt(sum a^2 + 1e-10)``) and the distance is the sum over taps of
the mean over pixels of the squared difference summed over channels.

``VGG16Features`` has torchvision's ``vgg16().features`` layout, so a
torchvision checkpoint ``<cache_dir>/<name>.{safetensors,bin,pt}`` (a
name of ``VGG_CHECKPOINT_NAMES``) loads its ``features.N`` keys strictly.
Without one the tower keeps a deterministic He-normal init (a random tower still measures
low-level structure; LPIPS parity needs the real weights). Images are NHWC
in [0, 1] at the interface, as in the JAX package; the convolutions are
plain ``conv2d`` (the JAX package computes them outside any kernel too).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.convert import find_checkpoint_file, load_state_dict_file
from dreammat_tpu_torch.utils.hw import resolve_device

# (out_channels, max-pool before) per conv, and torchvision's features index of each
VGG16_CONVS = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
TORCHVISION_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
# taps after these convs (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
TAPS = (1, 3, 6, 9, 12)

VGG_CHECKPOINT_NAMES = ("diffusion_pytorch_model", "model", "pytorch_model", "vgg16")

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """The conv tower in torchvision's ``features`` layout (conv, ReLU and
    max-pool modules at torchvision's indices; the last pool, which holds no
    weights and feeds no tap, left out)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        c_in = 3
        for c_out, pool in VGG16_CONVS:
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [nn.Conv2d(c_in, c_out, 3, padding=1), nn.ReLU()]
            c_in = c_out
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B,3,H,W] in [0,1] -> the five tap activations."""
        h = (x - self.mean) / self.std
        taps, conv = [], -1
        for layer in self.features:
            h = layer(h)
            if isinstance(layer, nn.Conv2d):
                conv += 1
            elif isinstance(layer, nn.ReLU) and conv in TAPS:
                taps.append(h)
        return taps


@torch.no_grad()
def init_vgg16(generator: torch.Generator, cache_dir: Optional[str] = "model/vgg16",
               device="cuda") -> VGG16Features:
    """The frozen tower on ``device``: He-normal weights (std sqrt(2 / 9 c_in))
    and zero biases from ``generator``, then torchvision's ``features.N``
    weights from a checkpoint in ``cache_dir`` where one exists (strictly:
    every conv of the tower, no other ``features`` key)."""
    model = VGG16Features().to(resolve_device(device))
    for m in model.features:
        if isinstance(m, nn.Conv2d):
            fan = m.weight.shape[1] * 9
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                       device=generator.device).to(device) * (2.0 / fan) ** 0.5)
            m.bias.zero_()
    ckpt = (find_checkpoint_file(cache_dir, VGG_CHECKPOINT_NAMES)
            if cache_dir and os.path.isdir(cache_dir) else None)
    if ckpt:
        sd = {k: v for k, v in load_state_dict_file(ckpt).items() if k.startswith("features.")}
        model.load_state_dict(sd, strict=True)
        dreammat_tpu_torch.info("loaded %d VGG16 convs from %s", len(sd) // 2, ckpt)
    return model.eval().requires_grad_(False)


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)


def perceptual_distance(model: VGG16Features, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The distance of the module docstring; x, y [B,H,W,3] in [0,1]."""
    B = x.shape[0]
    taps = model(torch.cat([x, y], dim=0).permute(0, 3, 1, 2))
    total = x.new_zeros(())
    for t in taps:
        a, b = _unit(t[:B]), _unit(t[B:])
        total = total + torch.mean(torch.sum((a - b) ** 2, dim=1))
    return total
