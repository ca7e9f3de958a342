"""DreamMat geometry: frozen mesh + learnable material field.

Counterpart of ``dreammat_tpu/models/geometry.py``: a hash-grid encoding +
small MLP maps surface points to ``n_feature_dims`` raw material features
(albedo 3, metallic 1, roughness^2 1). The mesh is frozen; the only
trainable state is the ``MaterialField`` module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.models.mesh import Mesh, load_mesh, make_icosphere
from dreammat_tpu_torch.ops import hashgrid as hg
from dreammat_tpu_torch.ops import mlp as mlp_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


class MaterialField(nn.Module):
    """table [L,T,F] + MLP; forward takes points already in [0,1]^D."""

    def __init__(self, enc_cfg: hg.HashGridConfig, mlp_dims):
        super().__init__()
        self.enc_cfg = enc_cfg
        self.table = nn.Parameter(torch.zeros(
            enc_cfg.n_levels, enc_cfg.table_size, enc_cfg.n_features_per_level))
        self.mlp = mlp_lib.make_mlp(mlp_dims)

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        return mlp_lib.apply_mlp(self.mlp, hg.hashgrid_encode(self.table, x01, self.enc_cfg))


@dreammat_tpu_torch.register("dreammat-mesh")
class DreamMatMesh(BaseObject):
    @dataclass
    class Config:
        radius: float = 1.0
        n_input_dims: int = 3
        n_feature_dims: int = 5
        pos_encoding_config: dict = field(default_factory=lambda: {
            "otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
            "log2_hashmap_size": 19, "base_resolution": 16,
            "per_level_scale": 1.447269237440378,
        })
        mlp_network_config: dict = field(default_factory=lambda: {
            "otype": "VanillaMLP", "activation": "ReLU", "output_activation": "none",
            "n_neurons": 64, "n_hidden_layers": 1,
        })
        shape_init: str = "???"
        shape_init_params: Optional[Any] = None
        shape_init_mesh_up: str = "+z"
        shape_init_mesh_front: str = "+x"

    cfg: Config

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        if self.cfg.n_input_dims != 3:
            raise NotImplementedError("the UV-space (2D) field is not ported yet")
        pc = dict(self.cfg.pos_encoding_config)
        pc.pop("otype", None)
        self.enc_cfg = hg.HashGridConfig(n_input_dims=3, **pc)
        nc = self.cfg.mlp_network_config
        self.mlp_dims = mlp_lib.vanilla_mlp_dims(
            self.enc_cfg.n_output_dims, self.cfg.n_feature_dims,
            n_neurons=nc.get("n_neurons", 64), n_hidden_layers=nc.get("n_hidden_layers", 1),
        )
        r = self.cfg.radius
        self.bbox = torch.tensor([[-r, -r, -r], [r, r, r]], dtype=torch.float32, device=self.device)
        self.mesh: Optional[Mesh] = None
        init = self.cfg.shape_init
        if isinstance(init, str) and init.startswith("mesh:"):
            scale = self.cfg.shape_init_params
            self.mesh = load_mesh(
                init[5:], scale=float(scale) if scale is not None else None,
                mesh_up=self.cfg.shape_init_mesh_up, mesh_front=self.cfg.shape_init_mesh_front,
                device=self.device,
            )
        elif isinstance(init, str) and init.startswith("procedural:"):
            kind = init.split(":", 1)[1]
            if kind != "sphere":
                raise ValueError(f"unknown procedural shape '{kind}'")
            self.mesh = make_icosphere(int(self.cfg.shape_init_params or 2), device=self.device)

    def isosurface(self) -> Mesh:
        if self.mesh is None:
            raise ValueError("mesh not initialized (shape_init missing)")
        return self.mesh

    def init(self, generator: torch.Generator) -> MaterialField:
        """A fresh field: table U(-1e-4, 1e-4), Kaiming-uniform MLP."""
        f = MaterialField(self.enc_cfg, self.mlp_dims).to(self.device)
        with torch.no_grad():
            f.table.copy_((torch.rand(f.table.shape, generator=generator, device=self.device)
                           * 2 - 1) * 1e-4)
        mlp_lib.init_mlp_(f.mlp, generator)
        return f

    def apply(self, field_: MaterialField, points: torch.Tensor) -> torch.Tensor:
        """World points [...,3] -> raw features [..., n_feature_dims]."""
        x = (points - self.bbox[0]) / (self.bbox[1] - self.bbox[0])
        return field_(torch.clamp(x, 0.0, 1.0))
