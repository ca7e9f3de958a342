"""GAN volume renderer (Control4D): a low-resolution NeRF and a conv
super-resolution.

Counterpart of ``gan-volume-renderer`` in
``dreammat_tpu/models/gan_renderer.py``. A training or eval render of an
H x W ray grid renders every s-th ray from s // 2 on (s = 2^(L-1),
L = len(ch_mult)) through the base renderer (draws under ``base/``); its
features are 3 RGB channels and a latent tail of 2 z_channels moments
(``hybrid-rgb-latent-material``). The generator upsamples [lr_rgb, z] by
s, conditioned on a global appearance code. Three generator levels choose
where the code and the latent come from:

- 0: the global code of the low-resolution render itself;
- 1: the global code of the target image ``gt_rgb``;
- 2: as 1, and the latent is the local encoder's of ``gt_rgb``.

z is the latent's mean in evaluation and a sample of it in training
(``gan_z`` draws); level 2 always samples the local encoder's latent, with
the one ``gan_z`` map that the JAX package's one key gives both its
samples. Both the generator's output and
the low-resolution render are resized to H x W (half-pixel linear), the
former clamped to [0, 1] (``comp_gan_rgb``), the latter ``comp_rgb``;
``kl`` is the latent's KL. In training with a target and ``int_offsets``
(iy, ix), a stride-8 probe of the grid from (iy, ix) is rendered at full
resolution (draws under ``probe/``) beside the target's pixels there
(``comp_int_rgb``, ``comp_gt_rgb``).

The four networks (``GANNetworks``: generator, local and global encoders,
PatchGAN discriminator) belong to the system's state, which trains the
discriminator with its own optimizer. ``render_image`` renders the base
pass in chunks of the base renderer's ``eval_chunk_rays``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.models.detectors import resize_linear
from dreammat_tpu_torch.models.volume_renderer import PrefixedDraws
from dreammat_tpu_torch.utils import gan
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


class GANNetworks(nn.Module):
    """The generator, the two encoders and the discriminator."""

    def __init__(self, cfg):
        super().__init__()
        mult = tuple(cfg.ch_mult)
        self.generator = gan.Generator(3 + cfg.z_channels, cfg.global_dim, ch=cfg.ch,
                                       ch_mult=mult)
        self.local_encoder = gan.LocalEncoder(ch=cfg.local_ch, ch_mult=mult,
                                              z_channels=cfg.z_channels)
        self.global_encoder = gan.GlobalEncoder(n_class=cfg.global_dim)
        self.discriminator = gan.NLayerDiscriminator(ndf=cfg.disc_ndf, n_layers=cfg.disc_layers)

    def generator_side(self):
        """The parameters the generator-side optimizer trains."""
        for name in ("generator", "local_encoder", "global_encoder"):
            yield from getattr(self, name).parameters()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@dreammat_tpu_torch.register("gan-volume-renderer")
class GANVolumeRenderer(BaseObject):
    @dataclass
    class Config:
        base_renderer_type: str = "nerf-volume-renderer"
        base_renderer: Any = None
        ch: int = 64
        local_ch: int = 32
        ch_mult: Any = (1, 2, 4)
        z_channels: int = 4
        global_dim: int = 64
        disc_ndf: int = 64
        disc_layers: int = 3
        # mirrored from the base renderer for the systems' occupancy hooks
        estimator: str = "none"
        grid_prune: bool = False
        grid_update_every: int = 0

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
        for k in ("estimator", "grid_prune", "grid_update_every"):
            setattr(self.cfg, k, getattr(self.base.cfg, k, None))
        self.scale = 2 ** (len(tuple(self.cfg.ch_mult)) - 1)
        self.mesh = None

    def init_state(self):
        return self.base.init_state()

    def update_occ(self, geo_field, occ, draws):
        return self.base.update_occ(geo_field, occ, draws)

    def init_networks(self, generator: torch.Generator) -> GANNetworks:
        """The four networks on the device with flax's default init, drawn
        from ``generator``: LeCun-normal kernels (truncated at two standard
        deviations), zero biases, unit GroupNorm scales."""
        nets = GANNetworks(self.cfg).to(self.device)
        with torch.no_grad():
            for m in nets.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    std = (1.0 / fan_in) ** 0.5 / 0.8796256610342398
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
        return nets

    def _base_render(self, geo_field, bg_field, occ, ro, rd, lp, draws, step, is_train):
        """The base renderer on the rays; in evaluation in chunks of its
        ``eval_chunk_rays`` (the colour and the opacity only)."""
        if is_train:
            return self.base.render_rays(geo_field, bg_field, occ, ro, rd, lp, draws, step=step,
                                         is_train=True)
        C = getattr(self.base.cfg, "eval_chunk_rays", ro.shape[0])
        outs: Dict[str, list] = {}
        for i in range(0, ro.shape[0], C):
            o = self.base.render_rays(geo_field, bg_field, occ, ro[i:i + C], rd[i:i + C],
                                      lp[i:i + C], draws, step=step, is_train=False)
            for key in ("comp_rgb", "opacity"):
                outs.setdefault(key, []).append(o[key])
        return {k: torch.cat(v) for k, v in outs.items()}

    def render_rays(self, geo_field, bg_field, occ, rays_o, rays_d, light_positions, draws=None,
                    step: int = 0, is_train: bool = False, gan_nets: Optional[GANNetworks] = None,
                    gt_rgb: Optional[torch.Tensor] = None, generator_level: int = 0,
                    int_offsets=None, height: int = 0, width: int = 0) -> Dict[str, Any]:
        """The GAN render of the module docstring; rays [H*W,3] of the
        full-resolution grid ``height`` x ``width``, ``gt_rgb`` [H,W,3]."""
        H, W, s = height, width, self.scale
        pre = (lambda p: PrefixedDraws(draws, p)) if draws is not None else (lambda p: None)
        grids = [x.reshape(H, W, 3) for x in (rays_o, rays_d, light_positions)]
        sub = [x[s // 2::s, s // 2::s].reshape(-1, 3) for x in grids]
        out = self._base_render(geo_field, bg_field, occ, *sub, pre("base/"), step, is_train)
        Hl, Wl = len(range(s // 2, H, s)), len(range(s // 2, W, s))
        feat = out["comp_rgb"].reshape(1, Hl, Wl, -1)
        lr_rgb, latent = feat[..., :3], feat[..., 3:]
        out["comp_lr_rgb"] = lr_rgb[0].reshape(-1, 3)
        train_z = is_train and gt_rgb is not None

        if generator_level == 2:
            latent = _nhwc(gan_nets.local_encoder(_nchw(gt_rgb[None])))
        mean, _ = gan.gaussian_moments(latent)
        if train_z or generator_level == 2:
            z_map = gan.gaussian_sample(latent, draws.normal("gan_z", tuple(mean.shape)).to(
                mean.device))
        else:
            z_map = mean
        g_code = gan_nets.global_encoder(_nchw(lr_rgb if generator_level == 0 else gt_rgb[None]))
        gan_rgb = gan_nets.generator(_nchw(torch.cat([lr_rgb, z_map], dim=-1)), g_code)
        gan_rgb = resize_linear(gan_rgb, (H, W))
        comp_rgb = resize_linear(_nchw(lr_rgb), (H, W))
        out["comp_gan_rgb"] = torch.clamp(_nhwc(gan_rgb)[0], 0.0, 1.0).reshape(-1, 3)
        out["comp_rgb"] = _nhwc(comp_rgb)[0].reshape(-1, 3)
        out["kl"] = gan.gaussian_kl(latent)
        out["generator_level"] = generator_level

        if train_z and int_offsets is not None:
            iy, ix = (int(v) for v in int_offsets)
            take = lambda a: a[iy:iy + H - 7, ix:ix + W - 7][::8, ::8].reshape(-1, 3)
            out_int = self.base.render_rays(geo_field, bg_field, occ, *(take(x) for x in grids),
                                            pre("probe/"), step=step, is_train=True)
            out["comp_int_rgb"] = out_int["comp_rgb"][..., :3]
            out["comp_gt_rgb"] = take(gt_rgb)
        return out

    @torch.no_grad()
    def render_image(self, geo_field, bg_field, occ, rays_o, rays_d, light_position, draws=None,
                     step: int = 0, gan_nets: Optional[GANNetworks] = None,
                     **kw) -> Dict[str, torch.Tensor]:
        """Rays [H,W,3] and one light position [3] -> ``comp_rgb``,
        ``comp_gan_rgb`` [H,W,3] and ``opacity`` [H,W,1] (the low-resolution
        opacity resized)."""
        H, W = rays_o.shape[:2]
        lp = light_position.reshape(1, 3).expand(H * W, 3)
        out = self.render_rays(geo_field, bg_field, occ, rays_o.reshape(-1, 3),
                               rays_d.reshape(-1, 3), lp, draws, step=step, is_train=False,
                               gan_nets=gan_nets, height=H, width=W)
        res = {k: out[k].reshape(H, W, 3) for k in ("comp_rgb", "comp_gan_rgb")}
        side = int(round(out["opacity"].shape[0] ** 0.5))
        res["opacity"] = resize_linear(out["opacity"].reshape(1, side, side, 1).permute(0, 3, 1, 2),
                                       (H, W))[0].permute(1, 2, 0)
        return res
