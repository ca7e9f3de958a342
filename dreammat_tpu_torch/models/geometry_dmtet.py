"""Tetrahedra SDF grid (DMTet) geometry: an explicit, differentiable mesh.

Counterpart of ``tetrahedra-sdf-grid`` in
``dreammat_tpu/models/geometry_dmtet.py``: trainable SDF values (positive
inside) at the vertices of a tet lattice over the ``radius`` box, an
optional per-vertex deformation, and a hash grid and feature MLP that
colour the surface. The trainable state is a ``DMTetField`` module.

- ``init``: ``sphere`` and ``ellipsoid`` assign the analytic SDF
  ((1 - |v / p|) min(p)); ``None`` draws 0.1 N(0, 1); ``mesh:<path>``
  bakes the exact signed distance to the loaded mesh at the lattice
  vertices (``ops/shape_loss.py``). The deformation starts at zero and is
  absent under ``fix_geometry`` or without ``isosurface_deformable_grid``.
- ``isosurface``: the vertices moved by 0.45 cell tanh(deformation) (under
  half a cell, so no tet inverts) and ``marching_tets_fixed`` with the
  ``max_crossing_tets`` budget; under ``fix_geometry`` no gradient reaches
  the SDF or the deformation.
- ``export_features`` / ``export``: the feature MLP over the hash encoding
  of the point, normalized over the box.
- ``isosurface_mesh``: the host extractor (``ops/marching.py``) on the SDF
  over the undeformed lattice, as the JAX package exports it (the trained
  deformation is not applied there).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import dmtet
from dreammat_tpu_torch.ops import hashgrid as hg
from dreammat_tpu_torch.ops import mlp as mlp_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


class DMTetField(nn.Module):
    """sdf [Nv], deformation [Nv,3] (optional), table [L,T,F] and
    feature_mlp (both absent with ``geometry_only``)."""

    def __init__(self, sdf: torch.Tensor, deformation: bool, enc_cfg=None, feature_dims=None):
        super().__init__()
        self.sdf = nn.Parameter(sdf)
        if deformation:
            self.deformation = nn.Parameter(torch.zeros(sdf.shape[0], 3, device=sdf.device))
        if feature_dims is not None:
            self.table = nn.Parameter(torch.zeros(
                enc_cfg.n_levels, enc_cfg.table_size, enc_cfg.n_features_per_level,
                device=sdf.device))
            self.feature_mlp = mlp_lib.make_mlp(feature_dims).to(sdf.device)


def _params3(p) -> np.ndarray:
    return np.asarray(p if hasattr(p, "__len__") else [p] * 3, np.float32)


@dreammat_tpu_torch.register("tetrahedra-sdf-grid")
class TetrahedraSDFGrid(BaseObject):
    @dataclass
    class Config:
        radius: float = 1.0
        isosurface_resolution: int = 128
        isosurface_deformable_grid: bool = True
        max_crossing_tets: int = 1 << 17
        n_input_dims: int = 3
        n_feature_dims: int = 3
        pos_encoding_config: dict = field(default_factory=lambda: {
            "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
            "log2_hashmap_size": 19, "base_resolution": 16,
            "per_level_scale": 1.447269237440378,
        })
        mlp_network_config: dict = field(default_factory=lambda: {
            "otype": "VanillaMLP", "activation": "ReLU", "output_activation": "none",
            "n_neurons": 64, "n_hidden_layers": 1,
        })
        shape_init: Optional[str] = None  # "sphere" | "ellipsoid" | "mesh:<path>"
        shape_init_params: Any = 0.5
        geometry_only: bool = False
        fix_geometry: bool = False
        # accepted for the reference's configs; the fixed-budget soup needs
        # no outlier removal
        isosurface_remove_outliers: bool = False
        isosurface_outlier_n_faces_threshold: Any = 0.01
        force_shape_init: bool = False
        shape_init_mesh_up: str = "+z"
        shape_init_mesh_front: str = "+x"

    cfg: Config
    is_explicit_mesh: bool = True

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        lat = dmtet.build_tet_lattice(cfg.isosurface_resolution)
        r = cfg.radius
        self.lattice_verts = torch.from_numpy(lat.verts).to(self.device) * (2 * r) - r
        self.tets = torch.from_numpy(lat.tets).to(self.device).long()
        self.grid_cell = 2 * r / cfg.isosurface_resolution
        self.bbox = torch.tensor([[-r] * 3, [r] * 3], dtype=torch.float32, device=self.device)
        if not cfg.geometry_only:
            pc = dict(cfg.pos_encoding_config)
            pc.pop("otype", None)
            self.enc_cfg = hg.HashGridConfig(n_input_dims=cfg.n_input_dims, **pc)
            nc = cfg.mlp_network_config
            self.feature_dims = mlp_lib.vanilla_mlp_dims(
                self.enc_cfg.n_output_dims, cfg.n_feature_dims,
                n_neurons=nc.get("n_neurons", 64), n_hidden_layers=nc.get("n_hidden_layers", 1))
        else:
            self.enc_cfg = None
            self.feature_dims = None
        self.mesh = None

    # -- state ---------------------------------------------------------------
    def _initial_sdf(self, generator: torch.Generator) -> torch.Tensor:
        cfg = self.cfg
        if cfg.shape_init in ("sphere", "ellipsoid"):
            p = torch.from_numpy(_params3(cfg.shape_init_params)).to(self.device)
            sdf = 1.0 - torch.linalg.norm(self.lattice_verts / p, dim=-1)
            return sdf * float(p.min())
        if cfg.shape_init is None:
            return 0.1 * torch.randn(self.lattice_verts.shape[0], generator=generator,
                                     device=self.device)
        if cfg.shape_init.startswith("mesh:"):
            from dreammat_tpu_torch.models.mesh import load_mesh
            from dreammat_tpu_torch.ops.shape_loss import mesh_signed_distance

            m = load_mesh(cfg.shape_init[5:], scale=float(_params3(cfg.shape_init_params)[0]),
                          mesh_up=cfg.shape_init_mesh_up, mesh_front=cfg.shape_init_mesh_front,
                          device=self.device)
            return mesh_signed_distance(self.lattice_verts, m.v_pos[m.t_pos_idx.long()],
                                        inside_positive=True)
        raise ValueError(f"Unknown shape initialization type: {cfg.shape_init!r}")

    def init(self, generator: torch.Generator) -> DMTetField:
        """A fresh field: the initial SDF, a zero deformation, the table
        U(-1e-4, 1e-4) and a Kaiming-uniform feature MLP."""
        cfg = self.cfg
        f = DMTetField(self._initial_sdf(generator).float(),
                       cfg.isosurface_deformable_grid and not cfg.fix_geometry,
                       self.enc_cfg, self.feature_dims)
        if self.feature_dims is not None:
            with torch.no_grad():
                f.table.copy_((torch.rand(f.table.shape, generator=generator, device=self.device)
                               * 2 - 1) * 1e-4)
            mlp_lib.init_mlp_(f.feature_mlp, generator)
        return f

    # -- surface ---------------------------------------------------------------
    def isosurface(self, field_: DMTetField) -> dmtet.MTOutput:
        cfg = self.cfg
        verts = self.lattice_verts
        if hasattr(field_, "deformation"):
            verts = verts + 0.45 * self.grid_cell * torch.tanh(field_.deformation)
        sdf = field_.sdf
        if cfg.fix_geometry:
            sdf, verts = sdf.detach(), verts.detach()
        return dmtet.marching_tets_fixed(sdf, verts, self.tets, cfg.max_crossing_tets)

    # -- field queries -----------------------------------------------------------
    def export_features(self, field_: DMTetField, points: torch.Tensor) -> torch.Tensor:
        x = torch.clamp((points - self.bbox[0]) / (self.bbox[1] - self.bbox[0]), 0.0, 1.0)
        enc = hg.hashgrid_encode(field_.table, x.reshape(-1, 3), self.enc_cfg)
        return mlp_lib.apply_mlp(field_.feature_mlp, enc).reshape(
            *points.shape[:-1], self.cfg.n_feature_dims)

    def export(self, field_: DMTetField, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.feature_dims is None:
            return {}
        return {"features": self.export_features(field_, points)}

    @torch.no_grad()
    def isosurface_mesh(self, field_: DMTetField):
        """(vertices [V,3] f32, faces [F,3] i32) of the SDF's zero level set
        on the undeformed lattice (marching tetrahedra on the host)."""
        from dreammat_tpu_torch.ops.marching import marching_tets_grid

        res, r = self.cfg.isosurface_resolution + 1, self.cfg.radius
        xs = np.linspace(-r, r, res, dtype=np.float32)
        values = -field_.sdf.detach().float().cpu().numpy().reshape(res, res, res)
        return marching_tets_grid(values, xs)
