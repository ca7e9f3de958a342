"""NeRF volume renderer: dense, fixed-shape sampling and alpha compositing.

Counterpart of ``nerf-volume-renderer`` in
``dreammat_tpu/models/volume_renderer.py``, with its design kept: every
ray takes all ``num_samples_per_ray`` samples (no ragged sampler).

- ``ray_aabb``: the slab test gives each ray [t0, t1] inside the box.
- ``occgrid`` estimator: a binary occupancy grid (``occ`` > ``occ_threshold``,
  a [G,G,G] tensor that the system owns) tightens each ray's [t0, t1] to
  its occupied span by a fixed march of 2G probes, the samples are
  stratified in it (``ray_strat`` draws in training), and the density is
  masked at empty cells. ``update_occ`` is the EMA refresh from one
  jittered density probe per cell (``occ_jitter`` draws):
  occ = max(decay * occ, density * render_step_size).
- ``importance`` estimator: ``num_samples_per_ray_importance`` stratified
  coarse samples (``ray_coarse`` draws in training), their weights under
  no gradient, and an inverse-CDF resample of S sorted samples
  (``ray_importance`` draws, also in evaluation).
- Weights w_i = T_i (1 - exp(-sigma_i delta_i)), T an exclusive cumulative
  product; ``render_rays`` returns every key of the JAX renderer
  (``comp_rgb``, ``comp_rgb_fg``, ``comp_rgb_bg``, ``opacity``, ``depth``,
  ``z_variance``, ``weights``, ``t_points``, ``t_dirs``, ``points``,
  ``density``; with normals ``normal`` and ``comp_normal``, and
  ``normal_perturb`` from ``normal_perturb`` draws), and ``render_image``
  renders an [H,W] view in chunks of ``eval_chunk_rays`` rays.

``neus-volume-renderer`` (NeuS and VolSDF alphas over an ``implicit-sdf``,
on the same sampling stack) and ``patch-renderer`` (a strided global pass
and one full-resolution patch over a base renderer) follow the NeRF
renderer; their classes say how.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import safe_normalize


def ray_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Per-ray (t0, t1) of the slab test against the box; t1 <= t0 where
    the ray misses."""
    inv = 1.0 / torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    ta = (lo - rays_o) * inv
    tb = (hi - rays_o) * inv
    tmin = torch.minimum(ta, tb).amax(dim=-1)
    tmax = torch.maximum(ta, tb).amin(dim=-1)
    return torch.clamp(tmin, min=0.0), torch.clamp(tmax, min=0.0)


def _draw(draws, kind: str, name: str, shape, device) -> torch.Tensor:
    return getattr(draws, kind)(name, shape).to(device)


@dreammat_tpu_torch.register("nerf-volume-renderer")
class NeRFVolumeRenderer(BaseObject):
    @dataclass
    class Config:
        radius: float = 1.0
        num_samples_per_ray: int = 512
        estimator: str = "occgrid"  # "occgrid" | "importance" ("proposal" is "importance")
        grid_resolution: int = 32
        grid_prune: bool = True
        prune_alpha_threshold: bool = True
        grid_update_every: int = 16
        grid_ema_decay: float = 0.95
        occ_threshold: float = 0.01
        num_samples_per_ray_importance: int = 64
        randomized: bool = True
        near_plane: float = 0.0
        far_plane: float = 1.0e10
        return_comp_normal: bool = False
        return_normal_perturb: bool = False
        eval_chunk_rays: int = 8192

    cfg: Config
    is_volume: bool = True

    def __init__(self, cfg, geometry, material, background, device="cuda") -> None:
        self.geometry = geometry
        self.material = material
        self.background = background
        super().__init__(cfg, device=device)

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        r = self.cfg.radius
        self.bbox_lo = torch.tensor([-r, -r, -r], dtype=torch.float32, device=self.device)
        self.bbox_hi = torch.tensor([r, r, r], dtype=torch.float32, device=self.device)
        # nerfacc's render_step_size
        self.render_step_size = 1.732 * 2 * r / self.cfg.num_samples_per_ray
        self.mesh = None

    # -- occupancy grid -----------------------------------------------------
    def init_state(self) -> torch.Tensor:
        """An all-empty grid [G,G,G]; the systems run ``update_occ`` on it
        before the first render."""
        G = self.cfg.grid_resolution
        return torch.zeros(G, G, G, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def update_occ(self, geo_field, occ: torch.Tensor, draws) -> torch.Tensor:
        """The EMA refresh from one jittered density probe per cell."""
        G = self.cfg.grid_resolution
        cell = (self.bbox_hi - self.bbox_lo) / G
        ar = torch.arange(G, device=self.device, dtype=torch.float32)
        idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
        jitter = _draw(draws, "uniform", "occ_jitter", tuple(idx.shape), self.device)
        pts = self.bbox_lo + (idx + jitter) * cell
        occ_new = (self._occ_density(geo_field, pts) * self.render_step_size).reshape(G, G, G)
        return torch.maximum(occ * self.cfg.grid_ema_decay, occ_new)

    def _occ_density(self, geo_field, pts: torch.Tensor) -> torch.Tensor:
        return self.geometry.forward_density(geo_field, pts)[..., 0]

    def _occ_binary(self, occ: torch.Tensor) -> torch.Tensor:
        if not self.cfg.grid_prune:
            return torch.ones_like(occ, dtype=torch.bool)
        return occ > self.cfg.occ_threshold

    def _occ_at(self, occ_bin: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        G = self.cfg.grid_resolution
        u = (pts - self.bbox_lo) / (self.bbox_hi - self.bbox_lo)
        ij = torch.clamp((u * G).to(torch.int32), 0, G - 1).long()
        flat = (ij[..., 0] * G + ij[..., 1]) * G + ij[..., 2]
        return occ_bin.reshape(-1)[flat]

    # -- sampling -----------------------------------------------------------
    def _tighten_by_grid(self, occ_bin, rays_o, rays_d, t0, t1):
        """[t0, t1] shrunk to the span of occupied cells along the ray (2G
        probes); a ray through no occupied cell gets an empty span."""
        M = 2 * self.cfg.grid_resolution
        frac = (torch.arange(M, dtype=torch.float32, device=t0.device) + 0.5) / M
        t = t0[:, None] + frac[None, :] * (t1 - t0)[:, None]
        occ = self._occ_at(occ_bin, rays_o[:, None, :] + rays_d[:, None, :] * t[..., None])
        big = 1e9
        t_first = torch.where(occ, t, torch.full_like(t, big)).amin(dim=1)
        t_last = torch.where(occ, t, torch.full_like(t, -big)).amax(dim=1)
        any_occ = occ.any(dim=1)
        pad = (t1 - t0) / M
        nt0 = torch.where(any_occ, torch.maximum(t_first - pad, t0), t0)
        nt1 = torch.where(any_occ, torch.minimum(t_last + pad, t1), t0)
        return nt0, nt1

    def _stratified(self, draws, name: str, t0, t1, S: int, randomized: bool):
        N = t0.shape[0]
        frac = torch.arange(S, dtype=torch.float32, device=t0.device) / S
        if randomized:
            u = _draw(draws, "uniform", name, (N, S), t0.device) / S
        else:
            u = torch.full((N, S), 0.5 / S, device=t0.device)
        return t0[:, None] + (frac[None, :] + u) * (t1 - t0)[:, None]

    def _importance_resample(self, draws, t_coarse, w_coarse, t0, t1, S: int):
        """S sorted samples drawn by inverse CDF from the coarse weights."""
        N, Sc = w_coarse.shape
        cdf = torch.cumsum(w_coarse + 1e-5, dim=1)
        cdf = torch.cat([torch.zeros(N, 1, device=cdf.device), cdf / cdf[:, -1:]], dim=1)
        edges = torch.cat([t0[:, None], 0.5 * (t_coarse[:, 1:] + t_coarse[:, :-1]),
                           t1[:, None]], dim=1)  # [N,Sc+1]
        u = (torch.arange(S, dtype=torch.float32, device=t0.device) + 0.5) / S
        u = u[None, :] + _draw(draws, "uniform", "ray_importance", (N, S), t0.device) / S \
            - 0.5 / S
        u = torch.clamp(u, 0.0, 1.0 - 1e-6).contiguous()
        k = torch.clamp(torch.searchsorted(cdf.contiguous(), u, right=True), 1, Sc)
        c0, c1 = torch.gather(cdf, 1, k - 1), torch.gather(cdf, 1, k)
        e0, e1 = torch.gather(edges, 1, k - 1), torch.gather(edges, 1, k)
        frac = (u - c0) / torch.clamp(c1 - c0, min=1e-8)
        return e0 + frac * (e1 - e0)

    @staticmethod
    def _weights(sigma: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """w_i = T_i (1 - exp(-sigma_i delta_i)), T_i = exp(-sum_{j<i} sigma_j delta_j)."""
        sd = sigma * delta
        alpha = 1.0 - torch.exp(-sd)
        T = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]), torch.cumsum(sd[:, :-1], dim=1)],
                                 dim=1))
        return T * alpha

    # -- render -------------------------------------------------------------
    def _coarse_sigma(self, geo_field, pts: torch.Tensor) -> torch.Tensor:
        """The importance estimator's coarse density, under no gradient."""
        with torch.no_grad():
            return self.geometry.forward_density(geo_field, pts)[..., 0]

    def _samples(self, geo_field, occ, rays_o, rays_d, draws, randomized: bool, **kw):
        """(t0, t1, t [N,S], occ_bin or None) of the configured estimator
        (``kw`` go to ``_coarse_sigma``)."""
        cfg = self.cfg
        S = cfg.num_samples_per_ray
        t0, t1 = ray_aabb(rays_o, rays_d, self.bbox_lo, self.bbox_hi)
        t0 = torch.clamp(t0, min=cfg.near_plane)
        t1 = torch.clamp(torch.maximum(t1, t0), max=cfg.far_plane)
        occ_bin = None
        if cfg.estimator == "occgrid":
            occ_bin = self._occ_binary(occ)
            if cfg.grid_prune:
                t0, t1 = self._tighten_by_grid(occ_bin, rays_o, rays_d, t0, t1)
            t = self._stratified(draws, "ray_strat", t0, t1, S, randomized)
        elif cfg.estimator in ("importance", "proposal"):
            Sc = cfg.num_samples_per_ray_importance
            tc = self._stratified(draws, "ray_coarse", t0, t1, Sc, randomized)
            sigma_c = self._coarse_sigma(
                geo_field, rays_o[:, None, :] + rays_d[:, None, :] * tc[..., None], **kw)
            wc = self._weights(sigma_c, ((t1 - t0) / Sc)[:, None].expand_as(tc))
            t = self._importance_resample(draws, tc, wc, t0, t1, S)
        else:
            raise ValueError(f"unknown estimator {cfg.estimator}")
        return t0, t1, t, occ_bin

    @staticmethod
    def _deltas(t: torch.Tensor) -> torch.Tensor:
        dt = torch.diff(t, dim=1)
        return torch.clamp(torch.cat([dt, dt[:, -1:]], dim=1), min=1e-6)

    def _composite(self, w, t, rgb_s, rays_d, bg_field) -> Dict[str, torch.Tensor]:
        opacity = w.sum(dim=1, keepdim=True)
        depth = (w * t).sum(dim=1, keepdim=True)
        comp_rgb_fg = (w[..., None] * rgb_s).sum(dim=1)
        comp_rgb_bg = self.background(rays_d, bg_field)
        return {"comp_rgb": comp_rgb_fg + comp_rgb_bg * (1.0 - opacity),
                "comp_rgb_fg": comp_rgb_fg, "comp_rgb_bg": comp_rgb_bg, "opacity": opacity,
                "depth": depth, "z_variance": (w * (t - depth) ** 2).sum(dim=1, keepdim=True)}

    def render_rays(self, geo_field, bg_field, occ: Optional[torch.Tensor], rays_o, rays_d,
                    light_positions, draws=None, step: int = 0,
                    is_train: bool = False) -> Dict[str, torch.Tensor]:
        """Rays [N,3] (origins, directions, light positions) -> composited
        maps [N,C] and per-sample [N,S,...] outputs."""
        cfg = self.cfg
        t0, t1, t, occ_bin = self._samples(geo_field, occ, rays_o, rays_d, draws,
                                           bool(cfg.randomized and is_train))
        pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]  # [N,S,3]
        geo_out = self.geometry.apply(geo_field, pts,
                                      output_normal=getattr(self.material, "requires_normal",
                                                            False))
        sigma = geo_out["density"][..., 0]
        if occ_bin is not None and cfg.prune_alpha_threshold:
            sigma = sigma * self._occ_at(occ_bin, pts)
        sigma = sigma * (t1 > t0)[:, None]
        w = self._weights(sigma, self._deltas(t))

        t_dirs = rays_d[:, None, :].expand_as(pts)
        rgb_s = self.material(geo_out.get("features"), positions=pts,
                              shading_normal=geo_out.get("shading_normal"),
                              light_positions=light_positions[:, None, :], viewdirs=t_dirs,
                              draws=draws, step=step, is_train=is_train)
        out = {**self._composite(w, t, rgb_s, rays_d, bg_field), "weights": w, "t_points": t,
               "t_dirs": t_dirs, "points": pts, "density": sigma}
        if "normal" in geo_out:
            out["normal"] = geo_out["normal"]
            comp_normal = safe_normalize((w[..., None] * geo_out["normal"]).sum(dim=1))
            out["comp_normal"] = (comp_normal + 1.0) / 2.0 * out["opacity"]
            if is_train and cfg.return_normal_perturb:
                jitter = _draw(draws, "normal", "normal_perturb", tuple(pts.shape), pts.device)
                out["normal_perturb"] = self.geometry.apply(
                    geo_field, pts + jitter * 1e-2, output_normal=True)["normal"]
        return out

    @torch.no_grad()
    def render_image(self, geo_field, bg_field, occ, rays_o, rays_d, light_position, draws=None,
                     step: int = 0, **kw) -> Dict[str, torch.Tensor]:
        """Rays [H,W,3] and one light position [3] -> ``comp_rgb``,
        ``opacity``, ``depth`` (and ``comp_normal``) [H,W,C], rendered in
        chunks of ``eval_chunk_rays`` rays (``kw``: NeuS's ``var``)."""
        H, W = rays_o.shape[:2]
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        lp = light_position.reshape(1, 3).expand_as(ro)
        C = min(self.cfg.eval_chunk_rays, ro.shape[0])
        keys = ("comp_rgb", "opacity", "depth", "comp_normal")
        outs = {}
        for i in range(0, ro.shape[0], C):
            o = self.render_rays(geo_field, bg_field, occ, ro[i:i + C], rd[i:i + C],
                                 lp[i:i + C], draws, step=step, is_train=False, **kw)
            for key in keys:
                if key in o:
                    outs.setdefault(key, []).append(o[key])
        return {k: torch.cat(v).reshape(H, W, -1) for k, v in outs.items()}


def volsdf_density(sdf: torch.Tensor, inv_std) -> torch.Tensor:
    """VolSDF's Laplace-CDF density of the SDF, inv_std clamped to [0, 80]."""
    inv_std = torch.clamp(torch.as_tensor(inv_std, dtype=sdf.dtype, device=sdf.device), 0.0, 80.0)
    return inv_std * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() * inv_std))


class LearnedVariance(nn.Module):
    """NeuS's trainable raw variance ``_inv_std`` (a scalar)."""

    def __init__(self, init: float):
        super().__init__()
        self._inv_std = nn.Parameter(torch.tensor(float(init)))


@dreammat_tpu_torch.register("neus-volume-renderer")
class NeuSVolumeRenderer(NeRFVolumeRenderer):
    """NeuS and VolSDF volume rendering of an ``implicit-sdf`` geometry.

    Counterpart of ``neus-volume-renderer`` in
    ``dreammat_tpu/models/volume_renderer.py`` on the NeRF renderer's
    sampling stack; only the alphas differ. inv_std = clamp(exp(10 raw),
    1e-6, 1e6) with raw the ``LearnedVariance`` (``init_variance``; the
    systems hand it in as ``var``). NeuS: the SDF at the interval's ends is
    estimated from the annealed cosine (ratio = step /
    ``cos_anneal_end_steps``, 1 without annealing), iter_cos = -(relu(-cos/2
    + 1/2)(1 - ratio) + relu(-cos) ratio), and alpha = clamp((Phi(prev) -
    Phi(next) + 1e-5) / (Phi(prev) + 1e-5), 0, 1) with Phi the sigmoid of
    inv_std times the SDF. ``use_volsdf``: alpha = 1 - exp(-volsdf_density
    delta). Weights w_i = alpha_i prod_{j<i} (1 - alpha_j + 1e-7). The
    occupancy refresh takes ``volsdf_density(sdf, 20)``; the importance
    estimator's coarse pass the VolSDF density of the SDF (under no
    gradient) at the learned inv_std, so that, as in the JAX package, the
    variance's gradient also flows through the resampled positions.
    ``render_rays`` returns the NeRF renderer's keys (not ``density``) and
    ``sdf_grad`` and ``inv_std``."""

    @dataclass
    class Config(NeRFVolumeRenderer.Config):
        learned_variance_init: float = 0.3
        cos_anneal_end_steps: int = 0
        use_volsdf: bool = False

    cfg: Config

    def init_variance(self) -> LearnedVariance:
        return LearnedVariance(self.cfg.learned_variance_init).to(self.device)

    @staticmethod
    def inv_std(var: LearnedVariance) -> torch.Tensor:
        return torch.clamp(torch.exp(var._inv_std * 10.0), 1e-6, 1e6)

    def _occ_density(self, geo_field, pts: torch.Tensor) -> torch.Tensor:
        return volsdf_density(self.geometry.forward_sdf(geo_field, pts)[..., 0], 20.0)

    def _coarse_sigma(self, geo_field, pts: torch.Tensor, var=None) -> torch.Tensor:
        """The VolSDF density of the SDF (under no gradient) at the learned
        inv_std, whose gradient flows on."""
        with torch.no_grad():
            sdf = self.geometry.forward_sdf(geo_field, pts)[..., 0]
        return volsdf_density(sdf, self.inv_std(var))

    def _alphas(self, sdf, normal, dirs, delta, var, step: int) -> torch.Tensor:
        inv_std = self.inv_std(var)
        if self.cfg.use_volsdf:
            alpha = 1.0 - torch.exp(-volsdf_density(sdf, inv_std) * delta)
        else:
            true_cos = torch.sum(normal * dirs, dim=-1)
            end = self.cfg.cos_anneal_end_steps
            ratio = min(max(float(step) / end, 0.0), 1.0) if end > 0 else 1.0
            iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - ratio)
                         + torch.relu(-true_cos) * ratio)
            prev_cdf = torch.sigmoid((sdf - iter_cos * delta * 0.5) * inv_std)
            next_cdf = torch.sigmoid((sdf + iter_cos * delta * 0.5) * inv_std)
            alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
        T = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-7],
                                    dim=1), dim=1)
        return T * alpha

    def render_rays(self, geo_field, bg_field, occ: Optional[torch.Tensor], rays_o, rays_d,
                    light_positions, draws=None, step: int = 0, is_train: bool = False,
                    var: Optional[LearnedVariance] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if var is None:
            var = self.init_variance()
        t0, t1, t, occ_bin = self._samples(geo_field, occ, rays_o, rays_d, draws,
                                           bool(cfg.randomized and is_train), var=var)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        geo_out = self.geometry.apply(geo_field, pts, output_normal=True)
        normal = geo_out["normal"]
        t_dirs = rays_d[:, None, :].expand_as(pts)
        w = self._alphas(geo_out["sdf"][..., 0], normal, t_dirs, self._deltas(t), var, step)
        if occ_bin is not None and cfg.prune_alpha_threshold:
            w = w * self._occ_at(occ_bin, pts)
        w = w * (t1 > t0)[:, None]
        rgb_s = self.material(geo_out.get("features"), positions=pts, shading_normal=normal,
                              light_positions=light_positions[:, None, :], viewdirs=t_dirs,
                              draws=draws, step=step, is_train=is_train)
        out = self._composite(w, t, rgb_s, rays_d, bg_field)
        comp_normal = safe_normalize((w[..., None] * normal).sum(dim=1))
        return {**out, "weights": w, "t_points": t, "t_dirs": t_dirs, "points": pts,
                "normal": normal, "sdf_grad": geo_out["sdf_grad"],
                "comp_normal": (comp_normal + 1.0) / 2.0 * out["opacity"],
                "inv_std": self.inv_std(var)}


class PrefixedDraws:
    """A draws object whose names carry ``prefix`` (the patch renderer's two
    passes draw the same names)."""

    def __init__(self, draws, prefix: str):
        self.draws, self.prefix = draws, prefix

    def uniform(self, name, shape):
        return self.draws.uniform(self.prefix + name, shape)

    def normal(self, name, shape):
        return self.draws.normal(self.prefix + name, shape)

    def integers(self, name, low, high, shape):
        return self.draws.integers(self.prefix + name, low, high, shape)


# the keys of a render that are images ([N, C] per ray): upsampled from the
# global pass and pasted over by the patch
PATCH_IMAGE_KEYS = ("comp_rgb", "comp_rgb_fg", "comp_rgb_bg", "opacity", "depth", "comp_normal",
                    "z_variance")


@dreammat_tpu_torch.register("patch-renderer")
class PatchRenderer(BaseObject):
    """Full-resolution training at bounded memory: a strided global pass and
    one full-resolution patch.

    Counterpart of ``patch-renderer`` in
    ``dreammat_tpu/models/volume_renderer.py``. A training render of an
    H x W ray grid renders every ``global_downsample``-th ray from
    ``ds // 2`` on (draws under ``global/``) and a ``patch_size`` square at
    a random offset (``patch/``; the offset ``patch_y``, ``patch_x`` are
    integer draws in [0, H - PS]). The image keys (``PATCH_IMAGE_KEYS``) of
    the global pass are upsampled to H x W (bilinear, half-pixel centres,
    as ``jax.image.resize``; detached with ``global_detach``) and the
    patch's are pasted over them; every other output (the per-sample ones)
    is the global pass's. Evaluation, the occupancy grid and its refresh go
    to the base renderer."""

    @dataclass
    class Config:
        patch_size: int = 128
        base_renderer_type: str = "nerf-volume-renderer"
        base_renderer: Any = None
        global_detach: bool = False
        global_downsample: int = 4

    cfg: Config
    is_volume: bool = True

    def __init__(self, cfg, geometry, material, background, device="cuda") -> None:
        self.geometry = geometry
        self.material = material
        self.background = background
        super().__init__(cfg, device=device)

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.base = dreammat_tpu_torch.find(self.cfg.base_renderer_type)(
            self.cfg.base_renderer or {}, self.geometry, self.material, self.background,
            device=self.device)
        self.mesh = None
        # the systems read the occupancy knobs off the renderer's config
        for k in ("estimator", "grid_prune", "grid_update_every"):
            setattr(self.cfg, k, getattr(self.base.cfg, k, None))

    def init_state(self):
        return self.base.init_state()

    def update_occ(self, geo_field, occ, draws):
        return self.base.update_occ(geo_field, occ, draws)

    def render_image(self, *a, **kw):
        return self.base.render_image(*a, **kw)

    def render_rays(self, geo_field, bg_field, occ, rays_o, rays_d, light_positions, draws=None,
                    step: int = 0, is_train: bool = False, **kw) -> Dict[str, torch.Tensor]:
        if not is_train:
            return self.base.render_rays(geo_field, bg_field, occ, rays_o, rays_d,
                                         light_positions, draws, step=step, is_train=False, **kw)
        N = rays_o.shape[0]
        H = W = int(round(N ** 0.5))
        if H * W != N:
            raise ValueError(f"patch-renderer needs a square ray grid, got {N} rays")
        ds = self.cfg.global_downsample
        PS = min(self.cfg.patch_size, H, W)
        grids = [x.reshape(H, W, 3) for x in (rays_o, rays_d, light_positions)]
        sub = [x[ds // 2::ds, ds // 2::ds] for x in grids]
        out_g = self.base.render_rays(geo_field, bg_field, occ,
                                      *(x.reshape(-1, 3) for x in sub),
                                      PrefixedDraws(draws, "global/"), step=step, is_train=True,
                                      **kw)
        py = int(draws.integers("patch_y", 0, H - PS + 1, ()))
        px = int(draws.integers("patch_x", 0, W - PS + 1, ()))
        out_p = self.base.render_rays(geo_field, bg_field, occ,
                                      *(x[py:py + PS, px:px + PS].reshape(-1, 3) for x in grids),
                                      PrefixedDraws(draws, "patch/"), step=step, is_train=True,
                                      **kw)
        return self.merge(out_g, out_p, H, W, py, px)

    def merge(self, out_g: Dict[str, torch.Tensor], out_p: Dict[str, torch.Tensor], H: int,
              W: int, py: int, px: int) -> Dict[str, torch.Tensor]:
        """The global pass's outputs with its image keys upsampled to H x W
        and the patch's pasted over them at (py, px)."""
        PS = min(self.cfg.patch_size, H, W)
        ds = self.cfg.global_downsample
        Hg, Wg = len(range(ds // 2, H, ds)), len(range(ds // 2, W, ds))
        out = {}
        for key, vg in out_g.items():
            vp = out_p.get(key)
            if (key in PATCH_IMAGE_KEYS and vp is not None and vg.dim() == 2
                    and vg.shape[0] == Hg * Wg and vp.shape[0] == PS * PS):
                C = vg.shape[1]
                full = F.interpolate(vg.reshape(1, Hg, Wg, C).permute(0, 3, 1, 2), size=(H, W),
                                     mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
                if self.cfg.global_detach:
                    full = full.detach()
                full = full.contiguous()
                full[py:py + PS, px:px + PS] = vp.reshape(PS, PS, C)
                out[key] = full.reshape(H * W, C)
            else:
                out[key] = vg
        return out
