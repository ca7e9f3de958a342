"""Per-sample materials of the volume systems.

Counterpart of ``dreammat_tpu/models/material_simple.py``:

- ``diffuse-with-point-light-material``: Lambert shading from a point
  light, albedo = activation(features[..., :3]). In training the soft
  shading draws the diffuse share ``d`` (``soft_shading``, uniform ()) and
  sets diffuse = d, ambient = 1 - d; the shading mode comes from two
  uniforms (``shading_mode``, [2]): albedo when u0 > ``diffuse_prob``,
  else textureless when u1 < ``textureless_prob``, else shaded; albedo
  throughout the first ``ambient_only_steps`` steps. The mode is picked
  on the device (``torch.where``), with no sync to the host. In
  evaluation: albedo inside the ambient-only window, shaded after.
- ``no-material``: activation(features[..., :n_output_dims]).
- ``hybrid-rgb-latent-material``: the first 3 of ``n_output_dims``
  channels through the colour activation, the rest raw (an RGB head and
  an SD-latent tail side by side).
- ``sd-latent-adapter-material``: clamp((features[..., :4] @ A + 1) / 2)
  with A the fixed 4x3 ``SD_LATENT_RGB_ADAPTER`` (not trained, as in the
  JAX package), a linear approximation of the SD VAE decode.
- ``neural-radiance-material``: an MLP of (features[..., :input_feature_dims],
  the real SH basis of the view direction up to ``sh_degree`` <= 4, closed
  form) -> rgb through the colour activation. Its weights are fixed: a
  Kaiming-uniform init from ``seed`` (``RadianceField``, no gradient).

A material is called as ``material(features, positions, shading_normal,
light_positions, viewdirs, draws, step, is_train)`` -> rgb per sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import mlp as mlp_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import get_activation


@dreammat_tpu_torch.register("diffuse-with-point-light-material")
class DiffuseWithPointLightMaterial(BaseObject):
    @dataclass
    class Config:
        ambient_light_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
        diffuse_light_color: Tuple[float, float, float] = (0.9, 0.9, 0.9)
        ambient_only_steps: int = 1000
        diffuse_prob: float = 0.75
        textureless_prob: float = 0.5
        albedo_activation: str = "sigmoid"
        soft_shading: bool = False

    cfg: Config
    requires_normal: bool = True

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.ambient = torch.tensor(self.cfg.ambient_light_color, dtype=torch.float32,
                                    device=self.device)
        self.diffuse = torch.tensor(self.cfg.diffuse_light_color, dtype=torch.float32,
                                    device=self.device)

    def _albedo(self, features: torch.Tensor) -> torch.Tensor:
        if self.cfg.albedo_activation not in ("sigmoid", "scale_-11_01", "none"):
            raise ValueError(f"unknown albedo activation {self.cfg.albedo_activation}")
        return get_activation(self.cfg.albedo_activation)(features[..., :3])

    def __call__(self, features, positions, shading_normal, light_positions, viewdirs=None,
                 draws=None, step: int = 0, is_train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        albedo = self._albedo(features)
        if is_train and step < cfg.ambient_only_steps:
            return albedo
        if is_train and cfg.soft_shading and draws is not None:
            diffuse = draws.uniform("soft_shading", ()).to(albedo.device).expand(3)
            ambient = 1.0 - diffuse
        else:
            diffuse, ambient = self.diffuse, self.ambient
        ldir = light_positions - positions
        ldir = ldir / (torch.linalg.norm(ldir, dim=-1, keepdim=True) + 1e-8)
        ndotl = torch.clamp(torch.sum(shading_normal * ldir, dim=-1, keepdim=True), min=0.0)
        textureless = ndotl * diffuse + ambient
        shaded = torch.clamp(albedo, 0.0, 1.0) * textureless
        if not is_train:
            return albedo if step < cfg.ambient_only_steps else shaded
        u = (draws.uniform("shading_mode", (2,)).to(albedo.device) if draws is not None
             else torch.zeros(2, device=albedo.device))
        mode = torch.where(u[0] > cfg.diffuse_prob, 0, torch.where(u[1] < cfg.textureless_prob,
                                                                   1, 2))
        return torch.where(mode == 0, albedo,
                           torch.where(mode == 1, textureless.expand_as(shaded), shaded))

    def export(self, features: torch.Tensor):
        return {"albedo": torch.clamp(self._albedo(features), 0.0, 1.0)}


@dreammat_tpu_torch.register("no-material")
class NoMaterial(BaseObject):
    @dataclass
    class Config:
        n_output_dims: int = 3
        color_activation: str = "sigmoid"

    cfg: Config
    requires_normal: bool = False

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        if self.cfg.color_activation not in ("sigmoid", "scale_-11_01", "none"):
            raise ValueError(f"unknown color activation {self.cfg.color_activation}")

    def __call__(self, features, positions=None, shading_normal=None, light_positions=None,
                 viewdirs=None, draws=None, step: int = 0, is_train: bool = False):
        return get_activation(self.cfg.color_activation)(features[..., :self.cfg.n_output_dims])

    def export(self, features: torch.Tensor):
        return {"albedo": torch.clamp(self(features), 0.0, 1.0)}


def _color(name: str, x: torch.Tensor) -> torch.Tensor:
    if name not in ("sigmoid", "scale_-11_01", "none"):
        raise ValueError(f"unknown color activation {name}")
    return get_activation(name)(x)


@dreammat_tpu_torch.register("hybrid-rgb-latent-material")
class HybridRGBLatentMaterial(BaseObject):
    @dataclass
    class Config:
        n_output_dims: int = 7
        color_activation: str = "sigmoid"
        requires_normal: bool = True

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.requires_normal = self.cfg.requires_normal

    def __call__(self, features, positions=None, shading_normal=None, light_positions=None,
                 viewdirs=None, draws=None, step: int = 0, is_train: bool = False):
        f = features[..., :self.cfg.n_output_dims]
        return torch.cat([_color(self.cfg.color_activation, f[..., :3]), f[..., 3:]], dim=-1)

    def export(self, features: torch.Tensor):
        return {"albedo": torch.clamp(self(features)[..., :3], 0.0, 1.0)}


# the 4x3 map from SD latents to approximate RGB (the public decoder
# approximation), as in the JAX package
SD_LATENT_RGB_ADAPTER = (
    (0.298, 0.207, 0.208),
    (0.187, 0.286, 0.173),
    (-0.158, 0.189, 0.264),
    (-0.184, -0.271, -0.473),
)


@dreammat_tpu_torch.register("sd-latent-adapter-material")
class SDLatentAdapterMaterial(BaseObject):
    @dataclass
    class Config:
        pass

    cfg: Config
    requires_normal: bool = False

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.adapter = torch.tensor(SD_LATENT_RGB_ADAPTER, dtype=torch.float32, device=self.device)

    def __call__(self, features, positions=None, shading_normal=None, light_positions=None,
                 viewdirs=None, draws=None, step: int = 0, is_train: bool = False):
        return torch.clamp((features[..., :4] @ self.adapter + 1.0) / 2.0, 0.0, 1.0)

    def export(self, features: torch.Tensor):
        return {"albedo": self(features)}


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """The real SH basis up to ``degree`` <= 4 of unit directions [..., 3] ->
    [..., degree^2]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.31539156525252005 * (3.0 * z2 - 1.0), -1.0925484305920792 * xz,
                0.5462742152960396 * (x2 - y2)]
    if degree > 3:
        out += [-0.5900435899266435 * y * (3 * x2 - y2), 2.890611442640554 * xy * z,
                -0.4570457994644658 * y * (5 * z2 - 1), 0.3731763325901154 * z * (5 * z2 - 3),
                -0.4570457994644658 * x * (5 * z2 - 1), 1.445305721320277 * z * (x2 - y2),
                -0.5900435899266435 * x * (x2 - 3 * y2)]
    return torch.stack(out, dim=-1)


class RadianceField(nn.Module):
    """The radiance MLP of ``neural-radiance-material``."""

    def __init__(self, dims):
        super().__init__()
        self.mlp = mlp_lib.make_mlp(dims)


@dreammat_tpu_torch.register("neural-radiance-material")
class NeuralRadianceMaterial(BaseObject):
    @dataclass
    class Config:
        input_feature_dims: int = 8
        color_activation: str = "sigmoid"
        sh_degree: int = 3
        n_neurons: int = 16
        n_hidden_layers: int = 2
        seed: int = 0

    cfg: Config
    requires_normal: bool = False

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        if self.cfg.color_activation not in ("sigmoid", "none"):
            raise ValueError(f"unknown color activation {self.cfg.color_activation}")
        self.n_sh = self.cfg.sh_degree ** 2
        self.field = RadianceField(mlp_lib.vanilla_mlp_dims(
            self.cfg.input_feature_dims + self.n_sh, 3, n_neurons=self.cfg.n_neurons,
            n_hidden_layers=self.cfg.n_hidden_layers)).to(self.device)
        mlp_lib.init_mlp_(self.field.mlp,
                          torch.Generator(device=self.device).manual_seed(self.cfg.seed))
        self.field.requires_grad_(False)

    def __call__(self, features, positions=None, shading_normal=None, light_positions=None,
                 viewdirs=None, draws=None, step: int = 0, is_train: bool = False):
        if viewdirs is None:
            raise ValueError("neural-radiance-material needs viewdirs")
        inp = torch.cat([features[..., :self.cfg.input_feature_dims],
                         sh_basis(viewdirs, self.cfg.sh_degree)], dim=-1)
        return get_activation(self.cfg.color_activation)(mlp_lib.apply_mlp(self.field.mlp, inp))

    def export(self, features: torch.Tensor):
        """The radiance seen from +z (it depends on the view)."""
        z = torch.tensor([0.0, 0.0, 1.0], device=features.device).expand(
            *features.shape[:-1], 3)
        return {"albedo": torch.clamp(self(features, viewdirs=z), 0.0, 1.0)}
