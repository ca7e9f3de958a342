"""Implicit volume geometry: a hash grid and small MLPs give density and features.

Counterpart of ``implicit-volume`` in ``dreammat_tpu/models/geometry_volume.py``:
a multiresolution hash encoding of the point (normalized over the
``radius`` box) feeds a density MLP (1 channel) and a feature MLP
(``n_feature_dims``). A density bias is added before the activation so
that training starts from a centred blob: ``blob_magic3d`` (linear
falloff, scale (1 - |x| / std)), ``blob_dreamfusion`` (gaussian) or a
constant. Normals: ``finite_difference`` (forward differences on three
offsets), ``finite_difference_laplacian`` (central differences on six),
``pred`` (a third MLP) or ``analytic`` (minus the gradient of the density
with respect to the point, through autograd; differentiable in the field
when gradients are on). The trainable state is a ``VolumeField`` module.
``isosurface_mesh`` extracts the ``isosurface_threshold`` level set on a
``isosurface_resolution``^3 grid by marching tetrahedra (host numpy).

``volume-grid`` (``VolumeGrid``) is the same field on a dense trainable
grid [G1,G2,G3, 1 + Nf] with no MLP (``VolumeGridField``): the raw
density is channel 0 of ``trilinear_sample`` times ``exp(density_scale)``
(a trainable scalar), the features the other channels; the ``blob`` bias
is the linear falloff of ``blob_magic3d``; normals ``finite_difference``,
``finite_difference_laplacian`` or ``pred`` (a second grid [G1,G2,G3,3]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import hashgrid as hg
from dreammat_tpu_torch.ops import mlp as mlp_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import safe_normalize


class VolumeField(nn.Module):
    """table [L,T,F] and the density, feature (optional) and normal
    (``pred`` only) MLPs."""

    def __init__(self, enc_cfg: hg.HashGridConfig, density_dims, feature_dims=None,
                 normal_dims=None):
        super().__init__()
        self.enc_cfg = enc_cfg
        self.table = nn.Parameter(torch.zeros(
            enc_cfg.n_levels, enc_cfg.table_size, enc_cfg.n_features_per_level))
        self.density_mlp = mlp_lib.make_mlp(density_dims)
        if feature_dims is not None:
            self.feature_mlp = mlp_lib.make_mlp(feature_dims)
        if normal_dims is not None:
            self.normal_mlp = mlp_lib.make_mlp(normal_dims)


@dreammat_tpu_torch.register("implicit-volume")
class ImplicitVolume(BaseObject):
    @dataclass
    class Config:
        radius: float = 1.0
        n_input_dims: int = 3
        n_feature_dims: int = 3
        density_activation: str = "softplus"
        density_bias: Any = "blob_magic3d"  # float | "blob_magic3d" | "blob_dreamfusion"
        density_blob_scale: float = 10.0
        density_blob_std: float = 0.5
        pos_encoding_config: dict = field(default_factory=lambda: {
            "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
            "log2_hashmap_size": 19, "base_resolution": 16,
            "per_level_scale": 1.447269237440378,
        })
        mlp_network_config: dict = field(default_factory=lambda: {
            "otype": "VanillaMLP", "activation": "ReLU", "output_activation": "none",
            "n_neurons": 64, "n_hidden_layers": 1,
        })
        # "pred" | "finite_difference" | "finite_difference_laplacian" | "analytic"
        normal_type: str = "finite_difference"
        finite_difference_normal_eps: float = 0.01
        isosurface_threshold: float = 25.0
        isosurface_resolution: int = 96

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        pc = dict(self.cfg.pos_encoding_config)
        pc.pop("otype", None)
        self.enc_cfg = hg.HashGridConfig(n_input_dims=self.cfg.n_input_dims, **pc)
        nc = self.cfg.mlp_network_config
        dims = lambda n_out: mlp_lib.vanilla_mlp_dims(
            self.enc_cfg.n_output_dims, n_out, n_neurons=nc.get("n_neurons", 64),
            n_hidden_layers=nc.get("n_hidden_layers", 1))
        self.density_dims = dims(1)
        self.feature_dims = dims(self.cfg.n_feature_dims) if self.cfg.n_feature_dims > 0 else None
        self.normal_dims = dims(3) if self.cfg.normal_type == "pred" else None
        r = self.cfg.radius
        self.bbox = torch.tensor([[-r, -r, -r], [r, r, r]], dtype=torch.float32,
                                 device=self.device)
        self.mesh = None  # a volume carries no mesh

    def init(self, generator: torch.Generator) -> VolumeField:
        """A fresh field: table U(-1e-4, 1e-4), Kaiming-uniform MLPs."""
        f = VolumeField(self.enc_cfg, self.density_dims, self.feature_dims,
                        self.normal_dims).to(self.device)
        with torch.no_grad():
            f.table.copy_((torch.rand(f.table.shape, generator=generator, device=self.device)
                           * 2 - 1) * 1e-4)
        for name in ("density_mlp", "feature_mlp", "normal_mlp"):
            if hasattr(f, name):
                mlp_lib.init_mlp_(getattr(f, name), generator)
        return f

    # -- field --------------------------------------------------------------
    def _encode(self, field_: VolumeField, points: torch.Tensor) -> torch.Tensor:
        x = torch.clamp((points - self.bbox[0]) / (self.bbox[1] - self.bbox[0]), 0.0, 1.0)
        return hg.hashgrid_encode(field_.table, x.reshape(-1, 3), self.enc_cfg)

    def _density_bias(self, points: torch.Tensor):
        cfg = self.cfg
        if cfg.density_bias == "blob_dreamfusion":
            return cfg.density_blob_scale * torch.exp(
                -0.5 * torch.sum(points ** 2, dim=-1, keepdim=True) / cfg.density_blob_std ** 2)
        if cfg.density_bias == "blob_magic3d":
            return cfg.density_blob_scale * (
                1.0 - torch.sqrt(torch.sum(points ** 2, dim=-1, keepdim=True) + 1e-12)
                / cfg.density_blob_std)
        return float(cfg.density_bias)

    def _activate_density(self, points: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
        raw = raw + self._density_bias(points)
        act = self.cfg.density_activation
        if act == "softplus":
            return F.softplus(raw)
        if act in ("trunc_exp", "exp"):
            return torch.exp(torch.clamp(raw, -15.0, 15.0))
        if act == "none":
            return raw
        raise ValueError(f"unknown density activation {act}")

    def forward_density(self, field_: VolumeField, points: torch.Tensor) -> torch.Tensor:
        """World points [..., 3] -> activated density [..., 1]."""
        enc = self._encode(field_, points)
        raw = mlp_lib.apply_mlp(field_.density_mlp, enc).reshape(*points.shape[:-1], 1)
        return self._activate_density(points, raw)

    def _analytic_normal(self, field_: VolumeField, points: torch.Tensor) -> torch.Tensor:
        """Minus d density / d point; part of the graph when gradients are on."""
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            d = self.forward_density(field_, p)
            (g,) = torch.autograd.grad(d.sum(), p, create_graph=create)
        return -g

    def apply(self, field_: VolumeField, points: torch.Tensor,
              output_normal: bool = False) -> Dict[str, torch.Tensor]:
        """Density [..., 1], features [..., Nf] and, with ``output_normal``,
        the unit normal [..., 3] (also as ``shading_normal``)."""
        cfg = self.cfg
        lead = points.shape[:-1]
        enc = self._encode(field_, points)
        raw = mlp_lib.apply_mlp(field_.density_mlp, enc).reshape(*lead, 1)
        density = self._activate_density(points, raw)
        out = {"density": density}
        if self.feature_dims is not None:
            out["features"] = mlp_lib.apply_mlp(field_.feature_mlp, enc).reshape(
                *lead, cfg.n_feature_dims)
        if output_normal:
            if cfg.normal_type == "pred":
                normal = mlp_lib.apply_mlp(field_.normal_mlp, enc).reshape(*lead, 3)
            elif cfg.normal_type == "analytic":
                normal = self._analytic_normal(field_, points)
            else:
                normal = self._fd_normal(field_, points, density)
            normal = safe_normalize(normal)
            out["normal"] = normal
            out["shading_normal"] = normal
        return out

    def _fd_normal(self, field_, points: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
        """Minus the density's finite-difference gradient: forward differences
        on three offsets (``finite_difference``) or central on six
        (``finite_difference_laplacian``), the offset points clamped to the box."""
        cfg = self.cfg
        eps = cfg.finite_difference_normal_eps
        if cfg.normal_type == "finite_difference_laplacian":
            offs = torch.tensor([[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0],
                                 [0, 0, eps], [0, 0, -eps]], device=points.device)
            po = torch.clamp(points[..., None, :] + offs, -cfg.radius, cfg.radius)
            do = self.forward_density(field_, po)  # [..., 6, 1]
            return -0.5 * (do[..., 0::2, 0] - do[..., 1::2, 0]) / eps
        if cfg.normal_type == "finite_difference":
            offs = torch.tensor([[eps, 0, 0], [0, eps, 0], [0, 0, eps]], device=points.device)
            po = torch.clamp(points[..., None, :] + offs, -cfg.radius, cfg.radius)
            do = self.forward_density(field_, po)  # [..., 3, 1]
            return -(do[..., :, 0] - density) / eps
        raise ValueError(f"unknown normal type {cfg.normal_type}")

    # -- isosurface (export) ------------------------------------------------
    @torch.no_grad()
    def isosurface_mesh(self, field_: VolumeField, chunk: int = 1 << 18):
        """(vertices [V,3] f32, faces [F,3] i32) of the density level set at
        ``isosurface_threshold`` on a ``isosurface_resolution``^3 grid over the
        box (marching tetrahedra on the host)."""
        from dreammat_tpu_torch.ops.marching import marching_tets_grid

        res, r = self.cfg.isosurface_resolution, self.cfg.radius
        xs = np.linspace(-r, r, res, dtype=np.float32)
        grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
        pts = torch.from_numpy(grid).to(self.device)
        dens = torch.cat([self.forward_density(field_, pts[i:i + chunk])[..., 0]
                          for i in range(0, pts.shape[0], chunk)])
        values = dens.cpu().numpy().reshape(res, res, res)
        return marching_tets_grid(values - float(self.cfg.isosurface_threshold), xs)

    def export(self, field_: VolumeField, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.feature_dims is None:
            return {}
        enc = self._encode(field_, points)
        return {"features": mlp_lib.apply_mlp(field_.feature_mlp, enc).reshape(
            *points.shape[:-1], self.cfg.n_feature_dims)}


def trilinear_sample(grid: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """Trilinear fetch from a dense [G1,G2,G3,C] grid at [..., 3] points in
    [0, 1]: cell-centred with clamped borders (align_corners=False), as the
    JAX package's ``trilinear_sample``. The corners are read with
    ``index_select``, so the backward is ``index_add_``. The sizes enter
    as Python numbers (no host-to-device copy)."""
    G = grid.shape[:3]
    f = torch.stack([x01[..., a] * G[a] for a in range(3)], dim=-1) - 0.5
    i0 = torch.floor(f).long()
    w = (f - i0)[..., None]
    lo = torch.stack([torch.clamp(i0[..., a], 0, G[a] - 1) for a in range(3)], dim=-1)
    hi = torch.stack([torch.clamp(i0[..., a] + 1, 0, G[a] - 1) for a in range(3)], dim=-1)
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    flat = grid.reshape(-1, grid.shape[-1])
    lead = x01.shape[:-1]

    def at(ix, iy, iz):
        idx = ((ix * G[1] + iy) * G[2] + iz).reshape(-1)
        return flat.index_select(0, idx).reshape(*lead, grid.shape[-1])

    c000 = at(lo[..., 0], lo[..., 1], lo[..., 2])
    c100 = at(hi[..., 0], lo[..., 1], lo[..., 2])
    c010 = at(lo[..., 0], hi[..., 1], lo[..., 2])
    c110 = at(hi[..., 0], hi[..., 1], lo[..., 2])
    c001 = at(lo[..., 0], lo[..., 1], hi[..., 2])
    c101 = at(hi[..., 0], lo[..., 1], hi[..., 2])
    c011 = at(lo[..., 0], hi[..., 1], hi[..., 2])
    c111 = at(hi[..., 0], hi[..., 1], hi[..., 2])
    c00 = c000 * (1 - wx) + c100 * wx
    c10 = c010 * (1 - wx) + c110 * wx
    c01 = c001 * (1 - wx) + c101 * wx
    c11 = c011 * (1 - wx) + c111 * wx
    c0 = c00 * (1 - wy) + c10 * wy
    c1 = c01 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


class VolumeGridField(nn.Module):
    """grid [G1,G2,G3, 1+Nf] (zeros at init), the scalar ``density_scale``
    and, for ``pred`` normals, ``normal_grid`` [G1,G2,G3,3]."""

    def __init__(self, grid_size, n_feature_dims: int, pred_normal: bool):
        super().__init__()
        self.grid = nn.Parameter(torch.zeros(*grid_size, 1 + n_feature_dims))
        self.density_scale = nn.Parameter(torch.zeros(()))
        if pred_normal:
            self.normal_grid = nn.Parameter(torch.zeros(*grid_size, 3))


@dreammat_tpu_torch.register("volume-grid")
class VolumeGrid(ImplicitVolume):
    @dataclass
    class Config(ImplicitVolume.Config):
        grid_size: Any = (100, 100, 100)
        density_bias: Any = "blob"
        density_blob_scale: float = 5.0
        density_blob_std: float = 0.5
        isosurface_threshold: float = 1.0

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        if self.cfg.normal_type not in ("finite_difference", "finite_difference_laplacian",
                                        "pred"):
            raise ValueError(f"unknown normal type {self.cfg.normal_type}")
        r = self.cfg.radius
        self.bbox = torch.tensor([[-r, -r, -r], [r, r, r]], dtype=torch.float32,
                                 device=self.device)
        self.grid_size = tuple(int(g) for g in self.cfg.grid_size)
        self.feature_dims = self.cfg.n_feature_dims if self.cfg.n_feature_dims > 0 else None
        self.mesh = None

    def init(self, generator: torch.Generator) -> VolumeGridField:
        return VolumeGridField(self.grid_size, self.cfg.n_feature_dims,
                               self.cfg.normal_type == "pred").to(self.device)

    def _density_bias(self, points: torch.Tensor):
        cfg = self.cfg
        if cfg.density_bias == "blob":
            return cfg.density_blob_scale * (
                1.0 - torch.sqrt(torch.sum(points ** 2, dim=-1, keepdim=True) + 1e-12)
                / cfg.density_blob_std)
        return super()._density_bias(points)

    def _x01(self, points: torch.Tensor) -> torch.Tensor:
        return torch.clamp((points - self.bbox[0]) / (self.bbox[1] - self.bbox[0]), 0.0, 1.0)

    def forward_density(self, field_: VolumeGridField, points: torch.Tensor) -> torch.Tensor:
        raw = trilinear_sample(field_.grid[..., 0:1], self._x01(points))
        return self._activate_density(points, raw * torch.exp(field_.density_scale))

    def apply(self, field_: VolumeGridField, points: torch.Tensor,
              output_normal: bool = False) -> Dict[str, torch.Tensor]:
        out_grid = trilinear_sample(field_.grid, self._x01(points))
        density = self._activate_density(points,
                                          out_grid[..., 0:1] * torch.exp(field_.density_scale))
        out = {"density": density}
        if self.feature_dims is not None:
            out["features"] = out_grid[..., 1:]
        if output_normal:
            if self.cfg.normal_type == "pred":
                normal = trilinear_sample(field_.normal_grid, self._x01(points))
            else:
                normal = self._fd_normal(field_, points, density)
            normal = safe_normalize(normal)
            out["normal"] = normal
            out["shading_normal"] = normal
        return out

    def export(self, field_: VolumeGridField, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.feature_dims is None:
            return {}
        return {"features": trilinear_sample(field_.grid, self._x01(points))[..., 1:]}
