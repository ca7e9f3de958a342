"""Implicit SDF geometry: a hash grid and small MLPs give a signed distance and features.

Counterpart of ``implicit-sdf`` in ``dreammat_tpu/models/geometry_sdf.py``:
the hash encoding of the point (normalized over the ``radius`` box) feeds
an SDF MLP (1 channel, negative inside) and a feature MLP
(``n_feature_dims``); an analytic ``sdf_bias`` is added to the SDF
(``sphere``: |x| - r; ``ellipsoid``: |x / size| - 1; or a constant) so that
training starts from a closed shape. Normals: ``finite_difference``
(forward differences on three offsets, the offset points clamped to the
box) or ``analytic`` (autograd; differentiable in the field when gradients
are on). ``apply`` returns the unnormalized gradient as ``sdf_grad`` for
the eikonal loss and its unit vector as ``normal`` and ``shading_normal``.
The trainable state is an ``SDFField`` module.

``initialize_shape`` fits the field to a target SDF for
``shape_init_steps`` Adam steps (lr 1e-3) on 4096 points a step, uniform
in the box (``shape_init`` draws [steps, 4096, 3]): ``sphere``,
``ellipsoid`` or ``mesh:<path>``, whose target is ``mesh_signed_distance``
of the loaded mesh, negative inside. ``isosurface_mesh`` extracts the
``isosurface_threshold`` level set of the SDF (0: the surface).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import hashgrid as hg
from dreammat_tpu_torch.ops import mlp as mlp_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import safe_normalize


class SDFField(nn.Module):
    """table [L,T,F], the SDF MLP and the feature MLP (optional)."""

    def __init__(self, enc_cfg: hg.HashGridConfig, sdf_dims, feature_dims=None):
        super().__init__()
        self.table = nn.Parameter(torch.zeros(
            enc_cfg.n_levels, enc_cfg.table_size, enc_cfg.n_features_per_level))
        self.sdf_mlp = mlp_lib.make_mlp(sdf_dims)
        if feature_dims is not None:
            self.feature_mlp = mlp_lib.make_mlp(feature_dims)


@dreammat_tpu_torch.register("implicit-sdf")
class ImplicitSDF(BaseObject):
    @dataclass
    class Config:
        radius: float = 1.0
        n_input_dims: int = 3
        n_feature_dims: int = 3
        sdf_bias: Any = 0.0  # float | "sphere" | "ellipsoid"
        sdf_bias_params: Any = 0.5
        shape_init: Optional[str] = None  # "sphere" | "ellipsoid" | "mesh:<path>"
        shape_init_params: Any = 0.5
        shape_init_steps: int = 400
        shape_init_mesh_up: str = "+z"
        shape_init_mesh_front: str = "+x"
        pos_encoding_config: dict = field(default_factory=lambda: {
            "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
            "log2_hashmap_size": 19, "base_resolution": 16,
            "per_level_scale": 1.447269237440378,
        })
        mlp_network_config: dict = field(default_factory=lambda: {
            "otype": "VanillaMLP", "activation": "ReLU", "output_activation": "none",
            "n_neurons": 64, "n_hidden_layers": 1,
        })
        normal_type: str = "finite_difference"  # | "analytic"
        finite_difference_normal_eps: float = 0.01
        isosurface_resolution: int = 96
        isosurface_threshold: float = 0.0

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        if self.cfg.normal_type not in ("finite_difference", "analytic"):
            raise ValueError(f"unknown normal type {self.cfg.normal_type}")
        pc = dict(self.cfg.pos_encoding_config)
        pc.pop("otype", None)
        self.enc_cfg = hg.HashGridConfig(n_input_dims=self.cfg.n_input_dims, **pc)
        nc = self.cfg.mlp_network_config
        dims = lambda n_out: mlp_lib.vanilla_mlp_dims(
            self.enc_cfg.n_output_dims, n_out, n_neurons=nc.get("n_neurons", 64),
            n_hidden_layers=nc.get("n_hidden_layers", 1))
        self.sdf_dims = dims(1)
        self.feature_dims = dims(self.cfg.n_feature_dims) if self.cfg.n_feature_dims > 0 else None
        r = self.cfg.radius
        self.bbox = torch.tensor([[-r, -r, -r], [r, r, r]], dtype=torch.float32,
                                 device=self.device)
        self.mesh = None

    def init(self, generator: torch.Generator) -> SDFField:
        """A fresh field: table U(-1e-4, 1e-4), Kaiming-uniform MLPs."""
        f = SDFField(self.enc_cfg, self.sdf_dims, self.feature_dims).to(self.device)
        with torch.no_grad():
            f.table.copy_((torch.rand(f.table.shape, generator=generator, device=self.device)
                           * 2 - 1) * 1e-4)
        for name in ("sdf_mlp", "feature_mlp"):
            if hasattr(f, name):
                mlp_lib.init_mlp_(getattr(f, name), generator)
        return f

    # -- field ---------------------------------------------------------------
    def _encode(self, field_: SDFField, points: torch.Tensor) -> torch.Tensor:
        x = torch.clamp((points - self.bbox[0]) / (self.bbox[1] - self.bbox[0]), 0.0, 1.0)
        return hg.hashgrid_encode(field_.table, x.reshape(-1, 3), self.enc_cfg)

    def _sdf_bias(self, points: torch.Tensor):
        b = self.cfg.sdf_bias
        if b == "sphere":
            return torch.linalg.norm(points, dim=-1, keepdim=True) - float(self.cfg.sdf_bias_params)
        if b == "ellipsoid":
            size = torch.tensor(self.cfg.sdf_bias_params, dtype=torch.float32,
                                device=points.device)
            return torch.sqrt(torch.sum((points / size) ** 2, dim=-1, keepdim=True)) - 1.0
        return float(b)

    def forward_sdf(self, field_: SDFField, points: torch.Tensor) -> torch.Tensor:
        """World points [..., 3] -> signed distance [..., 1] (negative inside)."""
        enc = self._encode(field_, points)
        raw = mlp_lib.apply_mlp(field_.sdf_mlp, enc).reshape(*points.shape[:-1], 1)
        return raw + self._sdf_bias(points)

    def apply(self, field_: SDFField, points: torch.Tensor,
              output_normal: bool = False) -> Dict[str, torch.Tensor]:
        """``sdf`` [..., 1], ``features`` [..., Nf] and, with
        ``output_normal``, ``sdf_grad``, ``normal`` and ``shading_normal``
        [..., 3]."""
        cfg = self.cfg
        lead = points.shape[:-1]
        enc = self._encode(field_, points)
        sdf = mlp_lib.apply_mlp(field_.sdf_mlp, enc).reshape(*lead, 1) + self._sdf_bias(points)
        out = {"sdf": sdf}
        if self.feature_dims is not None:
            out["features"] = mlp_lib.apply_mlp(field_.feature_mlp, enc).reshape(
                *lead, cfg.n_feature_dims)
        if output_normal:
            if cfg.normal_type == "finite_difference":
                eps = cfg.finite_difference_normal_eps
                offs = torch.tensor([[eps, 0, 0], [0, eps, 0], [0, 0, eps]], device=points.device)
                po = torch.clamp(points[..., None, :] + offs, -cfg.radius, cfg.radius)
                grad = (self.forward_sdf(field_, po)[..., :, 0] - sdf) / eps
            else:
                create = torch.is_grad_enabled()
                with torch.enable_grad():
                    p = points.detach().requires_grad_(True)
                    (grad,) = torch.autograd.grad(self.forward_sdf(field_, p).sum(), p,
                                                  create_graph=create)
            out["sdf_grad"] = grad
            normal = safe_normalize(grad)
            out["normal"] = normal
            out["shading_normal"] = normal
        return out

    # -- shape init ------------------------------------------------------------
    def _shape_target(self):
        cfg = self.cfg
        if cfg.shape_init == "sphere":
            r = float(cfg.shape_init_params)
            return lambda p: torch.linalg.norm(p, dim=-1, keepdim=True) - r
        if cfg.shape_init == "ellipsoid":
            size = torch.tensor(cfg.shape_init_params, dtype=torch.float32, device=self.device)
            return lambda p: torch.sqrt(torch.sum((p / size) ** 2, dim=-1, keepdim=True)) - 1.0
        if cfg.shape_init.startswith("mesh:"):
            from dreammat_tpu_torch.models.mesh import load_mesh
            from dreammat_tpu_torch.ops.shape_loss import mesh_signed_distance

            m = load_mesh(cfg.shape_init[5:], scale=float(cfg.shape_init_params),
                          mesh_up=cfg.shape_init_mesh_up, mesh_front=cfg.shape_init_mesh_front,
                          device=self.device)
            tri = m.v_pos[m.t_pos_idx.long()]
            return lambda p: mesh_signed_distance(p, tri, inside_positive=False,
                                                  chunk=1024)[:, None]
        raise ValueError(f"Unknown shape initialization type: {cfg.shape_init}")

    def initialize_shape(self, field_: SDFField, draws) -> SDFField:
        """``field_`` fitted in place to the ``shape_init`` target (nothing
        without one)."""
        cfg = self.cfg
        if cfg.shape_init is None:
            return field_
        target = self._shape_target()
        steps, r = cfg.shape_init_steps, cfg.radius
        pts_all = draws.uniform("shape_init", (steps, 4096, 3)).to(self.device) * (2 * r) - r
        opt = torch.optim.Adam(field_.parameters(), lr=1e-3)
        loss = None
        for i in range(steps):
            pts = pts_all[i]
            with torch.no_grad():
                want = target(pts)
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((self.forward_sdf(field_, pts) - want) ** 2)
            loss.backward()
            opt.step()
        field_.zero_grad(set_to_none=True)
        dreammat_tpu_torch.info("implicit-sdf shape init (%s): fit loss %.2e after %d steps",
                                cfg.shape_init, float(loss) if loss is not None else 0.0, steps)
        return field_

    # -- isosurface (export) ----------------------------------------------------
    @torch.no_grad()
    def isosurface_mesh(self, field_: SDFField, chunk: int = 1 << 18):
        """(vertices [V,3] f32, faces [F,3] i32) of the SDF's
        ``isosurface_threshold`` level set on a ``isosurface_resolution``^3
        grid (marching tetrahedra on the host)."""
        from dreammat_tpu_torch.ops.marching import marching_tets_grid

        res, r = self.cfg.isosurface_resolution, self.cfg.radius
        xs = np.linspace(-r, r, res, dtype=np.float32)
        grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
        pts = torch.from_numpy(grid).to(self.device)
        sdf = torch.cat([self.forward_sdf(field_, pts[i:i + chunk])[..., 0]
                         for i in range(0, pts.shape[0], chunk)])
        values = -(sdf.cpu().numpy().reshape(res, res, res) - float(self.cfg.isosurface_threshold))
        return marching_tets_grid(values, xs)

    def export(self, field_: SDFField, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.feature_dims is None:
            return {}
        enc = self._encode(field_, points)
        return {"features": mlp_lib.apply_mlp(field_.feature_mlp, enc).reshape(
            *points.shape[:-1], self.cfg.n_feature_dims)}
