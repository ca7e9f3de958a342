"""Data module: the fixed camera rig or random cameras, and per-step batches.

Counterpart of the mesh paths of ``dreammat_tpu/data/datamodule.py``:
``setup`` runs the prerender, the fast-path gate (``fastpath_check``:
``auto`` measures the mesh's self-occlusion first, ``true`` always checks,
``false`` never; a failed check drops the light tables, and training
shades through the MC estimator) and the optional per-pixel visibility
bake (``visibility_pixel_tables``, f16). ``collate`` picks a random
(view, env) pair with the same numpy RNG as the JAX package and assembles
the 22-channel condition stack (depth 1 + normal 3 + probes 18), the
view's light table (none after a drop, and none on every
``hybrid_mc_every``-th step) and its pixel table. ``eval_view`` builds one
view of the eval circle with its light table.

The prerender reads and writes its npz cache under ``prerender_cache_dir``
(null: no cache); with ``blender_generate`` and a ``reference_cache_dir``,
the condition maps come from the reference's Blender PNG cache there,
after the prerender and the gate, as in the JAX package.

Random-camera mode (``use_fix_views: false``): ``setup`` makes only the
mesh bakes and a fixed pixel budget (the foreground of the closest,
narrowest-fov probe camera x 1.1, rounded up to 1024); no gate, no pixel
tables, no hybrid steps. Every ``collate`` samples a camera with the same
numpy draws, in the same order, as the JAX package (elevation half the
time uniform in degrees and half uniform on the sphere, azimuth, distance,
fovy, the camera, centre and up perturbs, the ranges widened until
``progressive_until``; then the environment), casts its G-buffer (one
launch of kernel B on the card) and bakes its probes and light table.
Rays-only mode, for a volume renderer (or none): no mesh and no
prerender; every ``collate`` samples a camera with the draws above, then a
point light (``_sample_light``: the ``dreamfusion`` strategy, the camera
position plus a gaussian perturb, or ``magic3d``, lifted by the camera's
distance first; normalized to a distance uniform in
``light_distance_range``), and gives the camera's rays [H*W,3], its c2w
[1,4,4] and the light position per ray; ``eval_rays`` gives the rays of
an eval view with the light at the camera. ``static_field_maps`` is accepted; the port has no
sort maps (autograd's scatter serves the field backward) but keeps their
per-view jitter: with ``jitter_resample: "view"`` the jitter points are
drawn once per view.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.data import cameras as cam_lib
from dreammat_tpu_torch.data import prerender as prerender_lib
from dreammat_tpu_torch.data.prerender import _sync
from dreammat_tpu_torch.utils import ops as uops
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
        self._rays_only = renderer is None or getattr(renderer, "is_volume", False)
        self.renderer = renderer
        self.material = material
        self.cameras = cam_lib.make_fixed_cameras(
            cfg.fix_view_num, elevation_range=cfg.elevation_range,
            azimuth_range=cfg.azimuth_range, camera_distance_range=cfg.camera_distance_range,
            fovy_range=cfg.fovy_range, seed=cfg.seed,
        )
        self.eval_cameras = cam_lib.make_eval_cameras(
            cfg.n_test_views, cfg.eval_elevation_deg, cfg.eval_camera_distance,
            cfg.eval_fovy_deg)
        self.rng = np.random.RandomState(cfg.seed + 1)
        self.data: Optional[prerender_lib.PrerenderData] = None
        self._jitter_pts: List[Optional[torch.Tensor]] = [None] * cfg.fix_view_num
        self._pixel_vis: Optional[List[torch.Tensor]] = None
        self.gate: Dict[str, Any] = {}
        self._random_budget: Optional[int] = None
        self._eval_data: Optional[prerender_lib.PrerenderData] = None

    def setup(self) -> None:
        cfg = self.cfg
        if self._rays_only:
            return
        if not cfg.use_fix_views:
            self._setup_random()
            return
        self.data = prerender_lib.prerender(
            self.renderer, self.material, self.cameras, cfg.height, cfg.width, cfg.fix_env_num,
            cache_dir=cfg.prerender_cache_dir, cond_height=cfg.cond_height,
            cond_width=cfg.cond_width, pixel_budget=cfg.pixel_budget or None,
        )
        self.gate = self._fastpath_gate()
        if cfg.blender_generate and cfg.reference_cache_dir:
            lm, d, n = prerender_lib.load_reference_png_cache(
                cfg.reference_cache_dir, cfg.fix_view_num, cfg.fix_env_num,
                cfg.cond_height, cfg.cond_width)
            self.data.lightmaps = torch.from_numpy(lm).to(self.device)
            self.data.depths = torch.from_numpy(d).to(self.device)
            self.data.normals = torch.from_numpy(n).to(self.device)
            dreammat_tpu_torch.info("ingested reference Blender cache from %s",
                                    cfg.reference_cache_dir)
        self._pixel_vis = self._bake_pixel_tables() if cfg.visibility_pixel_tables else None
        if cfg.static_field_maps and self.renderer.cfg.jitter_resample == "view":
            draws = TorchDraws(cfg.seed + 7, self.device)
            self._jitter_pts = [self.renderer.draw_jitter_points(gb, draws)
                                for gb in self.data.gbuffers]

    def _fastpath_gate(self) -> Dict[str, Any]:
        """Decide whether training may shade through the prefiltered
        tables: measure the tables against the exact MC estimator on view
        0 (colour RMSE and gradient cosine) and drop them when either
        misses its threshold. Returns what was measured and decided, with
        the seconds each part took."""
        cfg = self.cfg
        t0 = time.time()
        gate: Dict[str, Any] = {"check": cfg.fastpath_check, "occlusion": None, "rmse": None,
                                "grad_cos": None, "decision": "not checked"}
        prefiltered = getattr(self.material.cfg, "use_prefiltered", False)
        check = cfg.fastpath_check
        if check == "auto":
            baked = self.material.baked_visibility
            if baked is None:
                # no table to probe self-occlusion with (raytrace / none):
                # tables in use are then always checked
                check = self.data.table_spec is not None and prefiltered
                if check:
                    dreammat_tpu_torch.info("fastpath_check=auto: no baked visibility to probe "
                                            "self-occlusion with; running the fidelity check")
            else:
                from dreammat_tpu_torch.ops.visibility import self_occlusion_fraction

                occ = self_occlusion_fraction(baked, self.renderer.mesh.v_nrm)
                gate["occlusion"] = occ
                check = occ >= cfg.fastpath_occlusion_threshold
                dreammat_tpu_torch.info(
                    "fastpath_check=auto: upper-hemisphere self-occlusion %.2f%% -> %s",
                    occ * 100.0, "running fidelity check" if check else "convex enough, skipping")
        if check and self.data.table_spec is not None and prefiltered:
            t1 = time.time()
            rmse = prerender_lib.fastpath_residual(self.renderer, self.material, self.data)
            _sync(self.device)
            gate["rmse"], gate["rmse_s"] = rmse, time.time() - t1
            gcos = None
            if cfg.fastpath_grad_cos_threshold > 0:
                t1 = time.time()
                gcos = prerender_lib.fastpath_grad_cos(self.renderer, self.material, self.data,
                                                       grad_pixels=cfg.fastpath_grad_pixels)
                _sync(self.device)
                gate["grad_cos"], gate["grad_cos_s"] = gcos, time.time() - t1
            gtxt = "n/a" if gcos is None else f"{gcos:.3f}"
            if rmse > cfg.fastpath_rmse_threshold or (
                    gcos is not None and gcos < cfg.fastpath_grad_cos_threshold):
                if self.material.baked_visibility is not None:
                    fallback = "per-sample MC with baked-visibility lookups (mc_baked)"
                elif self.material.ray_trace_fun is not None:
                    fallback = "exact MC with per-step BVH shadow rays"
                else:
                    fallback = "MC without shadow visibility"
                dreammat_tpu_torch.warn(
                    "fast-path check failed (relative color RMSE %.4f vs <= %.4f, grad-cos %s "
                    "vs >= %.2f): dropping prefiltered tables, training will shade through %s "
                    "(data.visibility_pixel_tables=true upgrades the fallback to per-pixel "
                    "visibility)", rmse, cfg.fastpath_rmse_threshold, gtxt,
                    cfg.fastpath_grad_cos_threshold, fallback)
                self.data.table_spec = None
                gate["decision"] = "dropped tables: " + fallback
            else:
                dreammat_tpu_torch.info(
                    "fast-path check: relative color RMSE %.4f (<= %.4f), grad-cos %s (>= %.2f) "
                    "vs exact MC", rmse, cfg.fastpath_rmse_threshold, gtxt,
                    cfg.fastpath_grad_cos_threshold)
                gate["decision"] = "kept tables"
        gate["seconds"] = time.time() - t0
        dreammat_tpu_torch.info("fast-path gate: %s in %.2fs (RMSE %.2fs, grad-cos %.2fs)",
                                gate["decision"], gate["seconds"], gate.get("rmse_s", 0.0),
                                gate.get("grad_cos_s", 0.0))
        return gate

    def _bake_pixel_tables(self) -> List[torch.Tensor]:
        """Per-pixel visibility tables [P, O^2] f16, one per view."""
        from dreammat_tpu_torch.ops import visibility as vis_lib

        t0 = time.time()
        oct_res = self.renderer.cfg.visibility_oct_res
        tables = [vis_lib.bake_pixel_visibility(self.renderer.bvh, gb.fg_pos, gb.fg_normal,
                                                oct_res=oct_res).table.half()
                  for gb in self.data.gbuffers]
        _sync(self.device)
        self.data.seconds["pixel_tables"] = time.time() - t0
        mb = sum(t.numel() for t in tables) * 2 / 1e6
        dreammat_tpu_torch.info("per-pixel visibility tables (mc_pixel) for %d views (%.0f MB) "
                                "in %.2fs", len(tables), mb, self.data.seconds["pixel_tables"])
        return tables

    def _setup_random(self) -> None:
        """The mesh bakes and the fixed pixel budget of the random cameras."""
        cfg = self.cfg
        t0 = time.time()
        self._bakes = prerender_lib.mesh_bakes(self.renderer, self.material, cfg.fix_env_num)
        budget = cfg.pixel_budget
        if not budget:
            # the largest foreground: the closest camera (perturbs can pull
            # it closer) with the narrowest field of view
            d = cfg.camera_distance_range[0] - cfg.camera_perturb
            f32 = lambda x: np.asarray([x], np.float32)
            probe = cam_lib.CameraSet(f32(0.0), f32(0.0), f32(d), f32(cfg.fovy_range[0]))
            cd = cam_lib.camera_rays_and_matrices(probe, 0, cfg.height, cfg.width,
                                                  device=self.device)
            gb = self.renderer.build_gbuffer(cd["rays_o"], cd["rays_d"], cd["w2c"])
            count = int(gb.fg_valid.sum())
            budget = int(np.ceil(max(count, 1) * 1.1 / 1024)) * 1024
        self._random_budget = budget
        self.data = None
        lvis, e_d_vertex, _, oct_res = self._bakes
        # the table source of the eval views
        self._eval_data = prerender_lib.PrerenderData(
            gbuffers=[], lightmaps=None, depths=None, normals=None, table_diff=e_d_vertex,
            lvis=lvis, oct_res=oct_res)
        _sync(self.device)
        dreammat_tpu_torch.info("random-camera mode: pixel budget %d, mesh bakes ready in %.2fs",
                                budget, time.time() - t0)

    def _sample_camera(self, step: int) -> Dict[str, Any]:
        """This step's camera, from ``self.rng`` in the JAX package's order."""
        cfg = self.cfg
        rng = self.rng
        r = min(1.0, step / (cfg.progressive_until + 1)) if cfg.progressive_until > 0 else 1.0
        elev_range = ((1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[0],
                      (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[1])
        azim_range = (r * cfg.azimuth_range[0], r * cfg.azimuth_range[1])
        if rng.rand() < 0.5:
            elevation = rng.rand() * (elev_range[1] - elev_range[0]) + elev_range[0]
        else:  # uniform on the sphere
            pct = [(elev_range[0] + 90.0) / 180.0, (elev_range[1] + 90.0) / 180.0]
            elevation = float(np.rad2deg(np.arcsin(
                2 * (rng.rand() * (pct[1] - pct[0]) + pct[0]) - 1.0)))
        azimuth = rng.rand() * (azim_range[1] - azim_range[0]) + azim_range[0]
        dist = (rng.rand() * (cfg.camera_distance_range[1] - cfg.camera_distance_range[0])
                + cfg.camera_distance_range[0])
        fovy_deg = rng.rand() * (cfg.fovy_range[1] - cfg.fovy_range[0]) + cfg.fovy_range[0]
        pos = uops.camera_position_from_spherical(float(elevation), float(azimuth),
                                                  float(dist)).numpy()
        pos = pos + (rng.rand(3) * 2.0 - 1.0) * cfg.camera_perturb
        center = rng.randn(3) * cfg.center_perturb
        up = np.asarray([0.0, 0.0, 1.0]) + rng.randn(3) * cfg.up_perturb
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)[None]
        c2w = uops.get_c2w(t(pos), t(center), t(up))[0]
        focal = 0.5 * cfg.height / np.tan(0.5 * np.deg2rad(fovy_deg))
        dirs = uops.get_ray_directions(cfg.height, cfg.width, float(focal), device=self.device)
        rays_o, rays_d = uops.get_rays(dirs, c2w, keepdim=True)
        return {"elevation": elevation, "azimuth": azimuth, "dist": dist, "fovy_deg": fovy_deg,
                "pos": pos, "c2w": c2w, "w2c": uops.get_w2c(c2w), "rays_o": rays_o,
                "rays_d": rays_d}

    def _collate_random(self, step: int) -> Dict[str, Any]:
        """A sampled camera's batch: its G-buffer, its condition stack under
        a random environment and its per-vertex light table [V,1+K,3]."""
        cfg = self.cfg
        cam = self._sample_camera(step)
        env_id = int(self.rng.randint(0, cfg.fix_env_num))
        gb = self.renderer.build_gbuffer_from_rays(cam["rays_o"], cam["rays_d"], cam["w2c"],
                                                   pixel_budget=self._random_budget)
        probes, tab, depth_c, normal_c = prerender_lib.probe_view_for_camera(
            self.renderer, self._bakes,
            torch.as_tensor(np.asarray(cam["pos"], np.float32), device=self.device), gb,
            cfg.fix_env_num, cfg.cond_height, cfg.cond_width)
        cond = torch.cat([depth_c.float(), normal_c.float(), probes[env_id].float()], dim=-1)
        f32 = lambda x: torch.tensor([float(x)], dtype=torch.float32, device=self.device)
        return {
            "view_id": -1,
            "env_id": env_id,
            "gbuffer": gb,
            "jitter_pts": None,
            "light_table": tab[env_id].float(),
            "pixel_vis": None,
            "condition_map": cond.permute(2, 0, 1)[None].contiguous(),  # [1,22,h,w]
            "elevation": f32(cam["elevation"]),
            "azimuth": f32(cam["azimuth"]),
            "camera_distances": f32(cam["dist"]),
            "height": cfg.height,
            "width": cfg.width,
        }

    def _sample_light(self, cam_pos: np.ndarray) -> np.ndarray:
        """A point light for a volume system's shading, from ``self.rng``
        in the JAX package's order (distance, then the perturb)."""
        cfg = self.cfg
        rng = self.rng
        d = (rng.rand() * (cfg.light_distance_range[1] - cfg.light_distance_range[0])
             + cfg.light_distance_range[0])
        if cfg.light_sample_strategy == "dreamfusion":
            v = cam_pos + rng.randn(3) * cfg.light_position_perturb
        elif cfg.light_sample_strategy == "magic3d":
            v = cam_pos + np.asarray([0.0, 0.0, 1.0]) * np.linalg.norm(cam_pos)
            v = v + rng.randn(3) * cfg.light_position_perturb
        else:
            raise ValueError(f"unknown light_sample_strategy {cfg.light_sample_strategy}")
        return (v / (np.linalg.norm(v) + 1e-8)) * d

    def _collate_rays(self, step: int) -> Dict[str, Any]:
        """A volume system's batch: a sampled camera's rays and a point light."""
        cfg = self.cfg
        cam = self._sample_camera(step)
        light = torch.as_tensor(np.asarray(self._sample_light(cam["pos"]), np.float32),
                                device=self.device)
        n = cfg.height * cfg.width
        f32 = lambda x: torch.tensor([float(x)], dtype=torch.float32, device=self.device)
        return {
            "view_id": -1,
            "env_id": 0,
            "c2w": cam["c2w"].reshape(1, 4, 4),
            "rays_o": cam["rays_o"].reshape(-1, 3),
            "rays_d": cam["rays_d"].reshape(-1, 3),
            "light_positions": light[None].expand(n, 3),
            "height": cfg.height,
            "width": cfg.width,
            "elevation": f32(cam["elevation"]),
            "azimuth": f32(cam["azimuth"]),
            "camera_distances": f32(cam["dist"]),
        }

    def eval_rays(self, i: int) -> Dict[str, Any]:
        """View ``i`` of the eval circle for a volume system: its rays
        [H,W,3], the light at the camera."""
        cfg = self.cfg
        cd = cam_lib.camera_rays_and_matrices(self.eval_cameras, i, cfg.eval_height,
                                              cfg.eval_width, device=self.device)
        f32 = lambda x: torch.tensor([float(x)], dtype=torch.float32, device=self.device)
        return {
            "rays_o": cd["rays_o"],
            "rays_d": cd["rays_d"],
            "light_position": cd["camera_position"].reshape(3),
            "elevation": f32(self.eval_cameras.elevation_deg[i]),
            "azimuth": f32(self.eval_cameras.azimuth_deg[i]),
        }

    def collate(self, step: int = 0) -> Dict[str, Any]:
        """One batch: a random fixed view and a random environment, in
        random-camera mode a sampled camera, in rays-only mode a sampled
        camera's rays and a point light."""
        cfg = self.cfg
        if self._rays_only:
            return self._collate_rays(step)
        if not cfg.use_fix_views:
            return self._collate_random(step)
        assert self.data is not None, "call setup() first"
        view_id = int(self.rng.randint(0, cfg.fix_view_num))
        env_id = int(self.rng.randint(0, cfg.fix_env_num))
        d = self.data
        cond = torch.cat([d.depths[view_id].float(), d.normals[view_id].float(),
                          d.lightmaps[view_id, env_id].float()], dim=-1)  # [h,w,22]
        hybrid_mc = cfg.hybrid_mc_every > 0 and step % cfg.hybrid_mc_every == 0
        light_table = None
        if d.table_spec is not None and not hybrid_mc:
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
            "pixel_vis": None if self._pixel_vis is None else self._pixel_vis[view_id],
            "condition_map": cond.permute(2, 0, 1)[None].contiguous(),  # [1,22,h,w]
            "elevation": f32(cam.elevation_deg[view_id]),
            "azimuth": f32(cam.azimuth_deg[view_id]),
            "camera_distances": f32(cam.camera_distances[view_id]),
            "height": cfg.height,
            "width": cfg.width,
        }

    def eval_view(self, i: int, env_id: int = 4) -> Dict[str, Any]:
        """View ``i`` of the eval circle under environment 4 (clamped to
        the configured count), as the reference's test views: its G-buffer
        (one pixel budget shared by the eval views) and, when the material
        uses the tables and the mesh bakes exist, its light table."""
        cfg = self.cfg
        env_id = min(env_id, cfg.fix_env_num - 1)
        cd = cam_lib.camera_rays_and_matrices(self.eval_cameras, i, cfg.eval_height,
                                              cfg.eval_width, device=self.device)
        budget = None
        scale = (cfg.eval_height * cfg.eval_width) / (cfg.height * cfg.width)
        if self.data is not None and self.data.gbuffers:
            budget = int(np.ceil(self.data.gbuffers[0].fg_idx.shape[0] * max(scale, 1.0)
                                 / 1024)) * 1024
        elif self._random_budget:
            budget = int(np.ceil(self._random_budget * max(scale, 1.0) / 1024)) * 1024
        gb = self.renderer.build_gbuffer(cd["rays_o"], cd["rays_d"], cd["w2c"],
                                         pixel_budget=budget)
        light_table = None
        table_src = self.data if self.data is not None else self._eval_data
        if table_src is not None and table_src.lvis is not None \
                and getattr(self.material.cfg, "use_prefiltered", False):
            light_table = prerender_lib.vertex_table_for_camera(
                self.renderer, self.material, table_src, cd["camera_position"], env_id)
        f32 = lambda x: torch.tensor([float(x)], dtype=torch.float32, device=self.device)
        ec = self.eval_cameras
        return {
            "env_id": env_id,
            "gbuffer": gb,
            "light_table": light_table,
            "elevation": f32(ec.elevation_deg[i]),
            "azimuth": f32(ec.azimuth_deg[i]),
            "camera_distances": f32(ec.camera_distances[i]),
            "height": cfg.eval_height,
            "width": cfg.eval_width,
        }
