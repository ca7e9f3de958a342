"""Backgrounds of the volume and mesh systems.

Counterparts in ``dreammat_tpu/models/background.py``:

- ``neural-environment-map-background``: the ray direction's frequency
  encoding (``dir_encoding_frequencies``, the input included) through a
  small MLP (``mlp_n_hidden_layers`` x ``mlp_n_neurons``, ReLU) and the
  colour activation. Its trainable state is a ``BackgroundField`` module.
- ``solid-color-background``: ``color`` tiled (or cut) to
  ``n_output_dims``; with ``learned`` the colour is the trainable
  ``color`` of a ``SolidColorField``, else the field holds nothing.
- ``textured-background``: a trainable equirect texture [H, W, C]
  (``TextureField``, N(0, 1) at init). A direction becomes its polar angle
  u = atan2(|xy|, z) / pi and azimuth v = atan2(y, x) / 2pi + 1/2; the
  texel coordinates are clamped in u and wrapped in v, the four texels
  are read with ``index_select`` (so the backward is ``index_add_``) and
  mixed bilinearly, then the colour activation.

(The DreamMat renderer composites over white and has no background
object.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import mlp as mlp_lib
from dreammat_tpu_torch.ops.hashgrid import frequency_encode, frequency_encoding_dims
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import get_activation


class BackgroundField(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.mlp = mlp_lib.make_mlp(dims)


@dreammat_tpu_torch.register("neural-environment-map-background")
class NeuralEnvironmentMapBackground(BaseObject):
    @dataclass
    class Config:
        n_output_dims: int = 3
        color_activation: str = "sigmoid"
        dir_encoding_frequencies: int = 4
        mlp_n_neurons: int = 16
        mlp_n_hidden_layers: int = 2

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.in_dim = frequency_encoding_dims(3, self.cfg.dir_encoding_frequencies)
        self.dims = ([self.in_dim] + [self.cfg.mlp_n_neurons] * self.cfg.mlp_n_hidden_layers
                     + [self.cfg.n_output_dims])
        self.activation = get_activation(self.cfg.color_activation)

    def init(self, generator: torch.Generator) -> BackgroundField:
        """A fresh MLP, Kaiming-uniform."""
        f = BackgroundField(self.dims).to(self.device)
        mlp_lib.init_mlp_(f.mlp, generator)
        return f

    def __call__(self, dirs: torch.Tensor, field_: BackgroundField) -> torch.Tensor:
        """Directions [..., 3] -> colours [..., n_output_dims]."""
        enc = frequency_encode(dirs, self.cfg.dir_encoding_frequencies)
        return self.activation(mlp_lib.apply_mlp(field_.mlp, enc))


class SolidColorField(nn.Module):
    """The learned colour [n_output_dims], or nothing."""

    def __init__(self, color: Optional[torch.Tensor] = None):
        super().__init__()
        if color is not None:
            self.color = nn.Parameter(color)


@dreammat_tpu_torch.register("solid-color-background")
class SolidColorBackground(BaseObject):
    @dataclass
    class Config:
        n_output_dims: int = 3
        color: Tuple = (1.0, 1.0, 1.0)
        learned: bool = False

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.color = torch.from_numpy(np.resize(np.asarray(self.cfg.color, np.float32),
                                                self.cfg.n_output_dims)).to(self.device)

    def init(self, generator: torch.Generator) -> SolidColorField:
        return SolidColorField(self.color.clone() if self.cfg.learned else None)

    def __call__(self, dirs: torch.Tensor, field_: Optional[SolidColorField] = None
                 ) -> torch.Tensor:
        """Directions [..., 3] -> the colour [..., n_output_dims]."""
        color = field_.color if field_ is not None and hasattr(field_, "color") else self.color
        return color.expand(*dirs.shape[:-1], self.cfg.n_output_dims)


class TextureField(nn.Module):
    """The trainable texture [H, W, C]."""

    def __init__(self, texture: torch.Tensor):
        super().__init__()
        self.texture = nn.Parameter(texture)


@dreammat_tpu_torch.register("textured-background")
class TexturedBackground(BaseObject):
    @dataclass
    class Config:
        n_output_dims: int = 3
        height: int = 64
        width: int = 64
        color_activation: str = "sigmoid"

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.activation = get_activation(self.cfg.color_activation)

    def init(self, generator: torch.Generator) -> TextureField:
        shape = (self.cfg.height, self.cfg.width, self.cfg.n_output_dims)
        return TextureField(torch.randn(shape, generator=generator, device=self.device))

    def __call__(self, dirs: torch.Tensor, field_: TextureField) -> torch.Tensor:
        """Directions [..., 3] -> colours [..., n_output_dims]."""
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        u = torch.atan2(torch.sqrt(x * x + y * y), z) / math.pi
        v = torch.atan2(y, x) / (2.0 * math.pi) + 0.5
        H, W, C = self.cfg.height, self.cfg.width, self.cfg.n_output_dims
        uf = torch.clamp(u * H - 0.5, 0.0, H - 1.0)
        vf = v * W - 0.5
        u0, v0 = torch.floor(uf).long(), torch.floor(vf).long()
        wu, wv = (uf - u0)[..., None], (vf - v0)[..., None]
        u1, u0 = torch.clamp(u0 + 1, 0, H - 1), torch.clamp(u0, 0, H - 1)
        v1, v0 = torch.remainder(v0 + 1, W), torch.remainder(v0, W)
        flat = field_.texture.reshape(H * W, C)
        at = lambda i, j: flat.index_select(0, (i * W + j).reshape(-1)).reshape(*i.shape, C)
        out = (at(u0, v0) * (1 - wu) * (1 - wv) + at(u1, v0) * wu * (1 - wv)
               + at(u0, v1) * (1 - wu) * wv + at(u1, v1) * wu * wv)
        return self.activation(out)
