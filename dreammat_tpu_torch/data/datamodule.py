"""Data module: the fixed camera rig, its prerender, and per-step batches.

Counterpart of the fixed-rig path of ``dreammat_tpu/data/datamodule.py``:
``setup`` runs the prerender and the fast-path gate, ``collate`` picks a
random (view, env) pair with the same numpy RNG as the JAX package and
assembles the 22-channel condition stack (depth 1 + normal 3 + probes 18)
and the view's light table on the device.

Not ported yet (each raises when asked for): random-camera mode, the
fast-path fidelity check itself (it needs the Monte-Carlo estimators),
per-pixel visibility tables, hybrid MC steps and the reference PNG cache.
``static_field_maps`` is accepted; the port has no sort maps (autograd's
scatter serves the field backward) but keeps their per-view jitter: with
``jitter_resample: "view"`` the jitter points are drawn once per view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.data import cameras as cam_lib
from dreammat_tpu_torch.data import prerender as prerender_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.rng import TorchDraws


@dreammat_tpu_torch.register("random-camera-datamodule")
class RandomCameraDataModule(BaseObject):
    @dataclass
    class Config:
        batch_size: int = 1
        width: int = 512
        height: int = 512
        eval_width: int = 512
        eval_height: int = 512
        camera_distance_range: Tuple[float, float] = (3.0, 4.0)
        fovy_range: Tuple[float, float] = (25.0, 45.0)
        elevation_range: Tuple[float, float] = (-20.0, 45.0)
        azimuth_range: Tuple[float, float] = (-180.0, 180.0)
        camera_perturb: float = 0.0
        center_perturb: float = 0.0
        up_perturb: float = 0.0
        batch_uniform_azimuth: bool = True
        eval_camera_distance: float = 4.0
        eval_fovy_deg: float = 30.0
        eval_elevation_deg: float = 15.0
        n_val_views: int = 1
        n_test_views: int = 120
        use_fix_views: bool = True
        progressive_until: int = 0
        light_sample_strategy: str = "dreamfusion"
        light_distance_range: Tuple[float, float] = (0.8, 1.5)
        light_position_perturb: float = 1.0
        blender_generate: bool = False
        reference_cache_dir: Optional[str] = None
        fix_view_num: int = 128
        fix_env_num: int = 5
        cond_height: int = 256
        cond_width: int = 256
        fastpath_check: Any = "auto"
        fastpath_occlusion_threshold: float = 0.01
        fastpath_rmse_threshold: float = 0.20
        fastpath_grad_cos_threshold: float = 0.5
        fastpath_grad_pixels: int = 4096
        hybrid_mc_every: int = 0
        visibility_pixel_tables: bool = False
        static_field_maps: bool = True
        static_maps_budget_mb: int = 6144
        static_maps_rotate: int = 8
        prerender_cache_dir: Optional[str] = ".dreammat_tpu_cache/prerender"
        pixel_budget: int = 0
        seed: int = 0

    cfg: Config

    def configure(self, renderer=None, material=None, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        if renderer is None or not cfg.use_fix_views:
            raise NotImplementedError(
                "only the fixed-camera rig with a mesh renderer is ported so far")
        if cfg.visibility_pixel_tables or cfg.hybrid_mc_every > 0 or (
                cfg.blender_generate and cfg.reference_cache_dir):
            raise NotImplementedError(
                "per-pixel visibility tables, hybrid MC steps and the reference PNG cache "
                "are not ported yet")
        self.renderer = renderer
        self.material = material
        self.cameras = cam_lib.make_fixed_cameras(
            cfg.fix_view_num, elevation_range=cfg.elevation_range,
            azimuth_range=cfg.azimuth_range, camera_distance_range=cfg.camera_distance_range,
            fovy_range=cfg.fovy_range, seed=cfg.seed,
        )
        self.rng = np.random.RandomState(cfg.seed + 1)
        self.data: Optional[prerender_lib.PrerenderData] = None
        self._jitter_pts: List[Optional[torch.Tensor]] = [None] * cfg.fix_view_num

    def setup(self) -> None:
        cfg = self.cfg
        if cfg.prerender_cache_dir:
            dreammat_tpu_torch.info("the prerender npz cache is not ported yet; rendering")
        self.data = prerender_lib.prerender(
            self.renderer, self.material, self.cameras, cfg.height, cfg.width, cfg.fix_env_num,
            cond_height=cfg.cond_height, cond_width=cfg.cond_width,
            pixel_budget=cfg.pixel_budget or None,
        )
        check = cfg.fastpath_check
        if check == "auto":
            from dreammat_tpu_torch.ops.visibility import self_occlusion_fraction

            occ = self_occlusion_fraction(self.material.baked_visibility,
                                          self.renderer.mesh.v_nrm)
            check = occ >= cfg.fastpath_occlusion_threshold
            dreammat_tpu_torch.info(
                "fastpath_check=auto: upper-hemisphere self-occlusion %.2f%% -> %s",
                occ * 100.0, "fidelity check needed" if check else "convex enough, skipping")
        if check and getattr(self.material.cfg, "use_prefiltered", False):
            raise NotImplementedError(
                "the fast-path fidelity check compares against the Monte-Carlo estimators, "
                "which are the next slice of the port; set data.fastpath_check=false to train "
                "on the tables without it")
        if cfg.static_field_maps and self.renderer.cfg.jitter_resample == "view":
            draws = TorchDraws(cfg.seed + 7, self.device)
            self._jitter_pts = [self.renderer.draw_jitter_points(gb, draws)
                                for gb in self.data.gbuffers]

    def collate(self, step: int = 0) -> Dict[str, Any]:
        """One batch: a random fixed view and a random environment."""
        cfg = self.cfg
        assert self.data is not None, "call setup() first"
        view_id = int(self.rng.randint(0, cfg.fix_view_num))
        env_id = int(self.rng.randint(0, cfg.fix_env_num))
        d = self.data
        cond = torch.cat([d.depths[view_id].float(), d.normals[view_id].float(),
                          d.lightmaps[view_id, env_id].float()], dim=-1)  # [h,w,22]
        light_table = torch.cat([d.table_diff[env_id][:, None].float(),
                                 d.table_spec[view_id, env_id].float()], dim=1)  # [V,1+K,3]
        cam = self.cameras
        f32 = lambda x: torch.tensor([float(x)], dtype=torch.float32, device=self.device)
        return {
            "view_id": view_id,
            "env_id": env_id,
            "gbuffer": d.gbuffers[view_id],
            "jitter_pts": self._jitter_pts[view_id],
            "light_table": light_table,
            "condition_map": cond.permute(2, 0, 1)[None].contiguous(),  # [1,22,h,w]
            "elevation": f32(cam.elevation_deg[view_id]),
            "azimuth": f32(cam.azimuth_deg[view_id]),
            "camera_distances": f32(cam.camera_distances[view_id]),
            "height": cfg.height,
            "width": cfg.width,
        }
