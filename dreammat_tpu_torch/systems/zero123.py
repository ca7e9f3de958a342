"""Zero123 systems: single image to 3D through novel-view guidance.

Counterpart of ``dreammat_tpu/systems/zero123.py`` on the port's DreamFusion
runtime (``fit``, ``test``, ``export``, the occupancy refresh):

- ``zero123-system``: every step renders the reference view and a random
  view in **one** render call (the two ray sets concatenated, the outputs
  split by ray count) and takes the reference-view losses (colour against
  the image composited over the render's own background, the mask's MSE;
  with a depth side file the scale/shift-aligned depth MSE and 1 - the
  masked Pearson r, the 2x2 solve under no gradient; with a normal side
  file 1 - the masked cosine), Zero123's SDS on the random view and the
  shared regularizers (the 2D normal smoothness, the 3D one against
  ``normal_perturb``; in the volume stage orient, sparsity and opaque, in
  the refinement the mesh's normal consistency). ``freq.ref_or_zero123``
  ``accumulate`` weighs both substeps every step; ``alternate`` weighs the
  reference substep alone for ``ref_only_steps`` steps and every
  ``n_ref``-th step after, Zero123's alone otherwise (``_substep_flags``,
  on the host). ``refinement`` switches an ``implicit-volume`` to
  ``tetrahedra-sdf-grid`` and the volume renderer to ``nvdiff-rasterizer``
  (kernel B's hit pass on the card). No prompt processor is built;
- ``zero123-simple-system``: Zero123's SDS on the random view with the
  orient, 2D normal smoothness, sparsity and opaque terms, no reference
  view;
- ``image-condition-dreamfusion-system``: the ``zero123-system`` step with
  the prompted SD guidance and its prompt processor.

The reference's ``ambient_ratio_min`` is accepted; the point-light
material's soft shading draws the shading mix per step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion, as_image
from dreammat_tpu_torch.systems.magic3d import switch_to_dmtet
from dreammat_tpu_torch.utils.schedule import C

# outputs of a render that are not per ray, shared by both views of a split
_SHARED_KEYS = ("mesh", "vertex_normals")


def masked_mean(x, m, eps: float = 1e-8):
    return torch.sum(x * m) / (torch.sum(m) + eps)


def masked_pearson(x, y, m, eps: float = 1e-8):
    """Pearson r of the flat ``x`` and ``y`` over the mask ``m``."""
    mx, my = masked_mean(x, m), masked_mean(y, m)
    vx, vy = masked_mean((x - mx) ** 2, m), masked_mean((y - my) ** 2, m)
    return masked_mean((x - mx) * (y - my), m) / (torch.sqrt(vx * vy) + eps)


def masked_depth_align(gt, pred, m, eps: float = 1e-6):
    """``gt`` scale/shift-aligned to ``pred`` under ``m`` through the 2x2
    normal equations, the solve under no gradient."""
    with torch.no_grad():
        s_m = torch.sum(m) + eps
        s_g, s_gg = torch.sum(m * gt), torch.sum(m * gt * gt)
        s_p, s_gp = torch.sum(m * pred), torch.sum(m * gt * pred)
        det = s_gg * s_m - s_g * s_g
        a = (s_gp * s_m - s_g * s_p) / (det + eps)
        b = (s_gg * s_p - s_g * s_gp) / (det + eps)
    return a * gt + b


def normal_smoothness_2d(comp_normal: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = comp_normal.reshape(h, w, 3)
    return torch.mean((n[1:, :] - n[:-1, :]) ** 2) + torch.mean((n[:, 1:] - n[:, :-1]) ** 2)


def render_ref_and_random(system: DreamFusion, batch: Dict[str, Any], draws
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The reference view and the random view of ``batch`` in one training
    render of ``system``; the outputs split by ray count (the mesh and its
    vertex normals go to both)."""
    rc = batch["random_camera"]
    n_ref = batch["rays_o"].shape[0]
    both = {k: torch.cat([batch[k], rc[k]]) for k in ("rays_o", "rays_d", "light_positions")}
    out = system.render_batch(both, draws, is_train=True, **system.train_render_kw())
    n_all = both["rays_o"].shape[0]
    out_r, out_z = {}, {}
    for key, val in out.items():
        if key not in _SHARED_KEYS and torch.is_tensor(val) and val.dim() >= 1 \
                and val.shape[0] == n_all:
            out_r[key], out_z[key] = val[:n_ref], val[n_ref:]
        else:
            out_r[key] = out_z[key] = val
    return out_r, out_z


def _zero123_guidance(system, seed: int) -> None:
    """Build ``system``'s guidance (no prompt processor)."""
    if system.guidance is None:
        system.guidance = dreammat_tpu_torch.find(system.cfg.guidance_type)(
            system.cfg.guidance, device=system.device)
        system.guidance.init_params(torch.Generator(device=system.device).manual_seed(seed))


@dreammat_tpu_torch.register("zero123-system")
class Zero123(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        guidance_type: str = "zero123-guidance"
        freq: dict = field(default_factory=dict)
        refinement: bool = False
        ambient_ratio_min: float = 0.5
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 0.1, "lambda_rgb": 500.0, "lambda_mask": 50.0, "lambda_depth": 0.0,
            "lambda_depth_rel": 0.0, "lambda_normal": 0.0, "lambda_normal_smooth": 0.0,
            "lambda_3d_normal_smooth": 0.0, "lambda_orient": 1.0, "lambda_sparsity": 0.5,
            "lambda_opaque": 0.5})

    cfg: Config
    # the guidance of image-condition-dreamfusion-system takes prompts
    _prompted = False

    def configure(self, device="cuda") -> None:
        if self.cfg.refinement:
            switch_to_dmtet(self.cfg)
        super().configure(device)

    def on_fit_start(self, seed: int = 0) -> None:
        if self._prompted:
            return super().on_fit_start(seed)
        _zero123_guidance(self, seed + 1)

    def train_render_kw(self) -> Dict[str, Any]:
        return {"render_rgb": True} if self.cfg.refinement else {}

    def _substep_flags(self, it: int) -> Tuple[float, float]:
        """(w_ref, w_zero123) of step ``it``."""
        freq = dict(self.cfg.freq or {})
        if freq.get("ref_or_zero123", "accumulate") == "accumulate":
            return 1.0, 1.0
        n_ref = max(int(freq.get("n_ref", 1)), 1)
        do_ref = it < int(freq.get("ref_only_steps", 0)) or it % n_ref == 0
        return (1.0, 0.0) if do_ref else (0.0, 1.0)

    def reference_losses(self, out_r, batch, step: int):
        """(weighted sum, metrics) of the reference view's losses."""
        lc = dict(self.cfg.loss)
        m = batch["mask"].reshape(-1)
        gt = batch["rgb"].reshape(-1, 3) * m[:, None] + out_r["comp_rgb_bg"] * (1.0 - m[:, None])
        mt = {"loss_rgb": torch.mean((gt - out_r["comp_rgb"]) ** 2),
              "loss_mask": torch.mean((m - out_r["opacity"][:, 0]) ** 2)}
        loss = C(lc.get("lambda_rgb", 0.0), step) * mt["loss_rgb"] \
            + C(lc.get("lambda_mask", 0.0), step) * mt["loss_mask"]
        if batch.get("ref_depth") is not None and (lc.get("lambda_depth", 0.0)
                                                   or lc.get("lambda_depth_rel", 0.0)):
            gd, pd = batch["ref_depth"].reshape(-1), out_r["depth"][:, 0]
            mt["loss_depth"] = masked_mean((masked_depth_align(gd, pd, m) - pd) ** 2, m)
            mt["loss_depth_rel"] = 1.0 - masked_pearson(pd, gd, m)
            loss = loss + C(lc.get("lambda_depth", 0.0), step) * mt["loss_depth"] \
                + C(lc.get("lambda_depth_rel", 0.0), step) * mt["loss_depth_rel"]
        if batch.get("ref_normal") is not None and lc.get("lambda_normal", 0.0):
            gn = 1.0 - 2.0 * batch["ref_normal"].reshape(-1, 3)
            pn = 2.0 * out_r["comp_normal"] - 1.0
            cos = torch.sum(gn * pn, dim=-1) / (torch.linalg.norm(gn, dim=-1)
                                                * torch.linalg.norm(pn, dim=-1) + 1e-8)
            mt["loss_normal"] = 1.0 - masked_mean(cos, m)
            loss = loss + C(lc.get("lambda_normal", 0.0), step) * mt["loss_normal"]
        return loss, mt

    def random_view_losses(self, out_z, rc, step: int):
        """(weighted sum, metrics) of the regularizers on the random view."""
        lc = dict(self.cfg.loss)
        loss, mt = 0.0, {}
        if "comp_normal" in out_z:
            mt["loss_normal_smooth"] = normal_smoothness_2d(out_z["comp_normal"], rc["height"],
                                                            rc["width"])
            loss = loss + C(lc.get("lambda_normal_smooth", 0.0), step) * mt["loss_normal_smooth"]
        if "normal_perturb" in out_z:
            mt["loss_3d_normal_smooth"] = torch.mean(
                torch.abs(out_z["normal"] - out_z["normal_perturb"]))
            loss = loss + C(lc.get("lambda_3d_normal_smooth", 0.0), step) \
                * mt["loss_3d_normal_smooth"]
        reg, shared = (self.mesh_regularizers(out_z, step) if self.cfg.refinement
                       else self.regularizers(out_z, step, rc))
        return loss + reg, {**mt, **shared}

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        step = self.global_step
        w_ref, w_z = self._substep_flags(step)
        rc = batch["random_camera"]
        self.optimizer.zero_grad(set_to_none=True)
        out_r, out_z = render_ref_and_random(self, batch, draws)
        loss_ref, metrics = self.reference_losses(out_r, batch, step)
        img = as_image(out_z["comp_rgb"], rc)
        view = (rc["elevation"], rc["azimuth"], rc["camera_distances"])
        if self._prompted:
            g = self.guidance(img, self.prompt_utils, *view, None, step=step, draws=draws)
        else:
            g = self.guidance(img, *view, step=step, draws=draws)
        loss_z, reg = self.random_view_losses(out_z, rc, step)
        loss = w_ref * loss_ref + w_z * (C(dict(self.cfg.loss).get("lambda_sds", 1.0), step)
                                         * g["loss_sds"] + loss_z)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss.detach(), "loss_sds": g["loss_sds"].detach(),
                **{k: v.detach() for k, v in {**metrics, **reg}.items()},
                "grad_norm": g["grad_norm"].detach(), "min_step": g["min_step"],
                "max_step": g["max_step"]}


@dreammat_tpu_torch.register("zero123-simple-system")
class Zero123Simple(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        guidance_type: str = "zero123-guidance"
        freq: dict = field(default_factory=dict)  # accepted
        ambient_ratio_min: float = 0.5
        refinement: bool = False  # accepted
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 0.1, "lambda_orient": 1.0, "lambda_normal_smoothness_2d": 0.0,
            "lambda_sparsity": 0.5, "lambda_opaque": 0.5})

    cfg: Config

    def on_fit_start(self, seed: int = 0) -> None:
        _zero123_guidance(self, seed + 1)

    def regularizers(self, out, step: int, batch=None):
        """DreamFusion's terms and, with its lambda set, the 2D normal smoothness."""
        loss, metrics = super().regularizers(out, step, batch)
        lam = dict(self.cfg.loss).get("lambda_normal_smoothness_2d", 0.0)
        if "comp_normal" in out and lam:
            metrics["loss_normal_smoothness_2d"] = normal_smoothness_2d(
                out["comp_normal"], batch["height"], batch["width"])
            loss = loss + C(lam, step) * metrics["loss_normal_smoothness_2d"]
        return loss, metrics

    def train_step(self, batch: Dict[str, Any], draws) -> Dict[str, torch.Tensor]:
        """SDS on the random view and ``regularizers``."""
        step = self.global_step
        rc = batch.get("random_camera", batch)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.render_batch(rc, draws, is_train=True)
        g = self.guidance(as_image(out["comp_rgb"], rc), rc["elevation"], rc["azimuth"],
                          rc["camera_distances"], step=step, draws=draws)
        reg, metrics = self.regularizers(out, step, rc)
        loss = C(dict(self.cfg.loss).get("lambda_sds", 1.0), step) * g["loss_sds"] + reg
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss.detach(), "loss_sds": g["loss_sds"].detach(),
                **{k: v.detach() for k, v in metrics.items()},
                "grad_norm": g["grad_norm"].detach(), "min_step": g["min_step"],
                "max_step": g["max_step"]}


@dreammat_tpu_torch.register("image-condition-dreamfusion-system")
class ImageConditionDreamFusion(Zero123):
    """The ``zero123-system`` step with the prompted SD guidance."""

    @dataclass
    class Config(Zero123.Config):
        guidance_type: str = "stable-diffusion-guidance"

    cfg: Config
    _prompted = True
