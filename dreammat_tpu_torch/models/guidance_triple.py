"""Triple-CFG guidance through public ControlNets (the texcraft family).

Counterpart of ``dreammat_tpu/models/guidance_triple.py``: the DreamMat
guidance's estimator, ``w(t) (cond eps_text + uncond eps_uncond + null
eps_null + noise n)``, conditioned through public SD ControlNets on maps
made each step:

- ``depth`` / ``self-normal``: channel 0 (repeated to three) and channels
  1:4 of the live condition stack that the texcraft system renders;
- ``canny``: ``soft_canny`` of the rendered image, the Sobel magnitude of
  its luma with a (lower, upper)/255 ramp in place of cv2's hysteresis;
- ``hed``: the HED network with the scribble post-process on the rendered
  image;
- ``normal``: NormalBae on the rendered image;
- ``light``: the whole condition stack.

The detectors load from ``hed_weights_path`` and ``normalbae_weights_path``
and run with random weights (with a warning) without them; NormalBae sees
the render at ``normalbae_detect_resolution`` (512, as in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import dreammat_tpu_torch
from dreammat_tpu_torch.models.detectors import load_hed, load_normalbae, soft_canny
from dreammat_tpu_torch.models.guidance import StableDiffusionLightGuidance


@dreammat_tpu_torch.register("stable-diffusion-triple-guidance")
class StableDiffusionTripleGuidance(StableDiffusionLightGuidance):
    @dataclass
    class Config(StableDiffusionLightGuidance.Config):
        use_controlnet: bool = False
        control_types: List = field(default_factory=lambda: ["depth", "canny"])
        condition_scales: List = field(default_factory=lambda: [1.0, 1.0])
        condition_scales_anneal: List = field(default_factory=lambda: [1.0, 1.0])
        condition_scale: float = 1.5
        canny_lower_bound: int = 50
        canny_upper_bound: int = 100
        hed_weights_path: str = ""
        normalbae_weights_path: str = ""
        # controlnet_aux's detect_resolution: NormalBae sees the render at this size
        normalbae_detect_resolution: int = 512
        p2p_condition_type: str = "p2p"

    cfg: Config

    def configure(self, device="cuda") -> None:
        # the public control types' conditioning channels
        self._cn_channels = {"depth": 3, "canny": 3, "self-normal": 3, "normal": 3, "hed": 3,
                             "light": 22}
        super().configure(device)
        cfg = self.cfg
        self._normalbae = self._hed = None
        if "normal" in cfg.control_types:
            self._normalbae = load_normalbae(cfg.normalbae_weights_path or None, self.device,
                                             detect_resolution=cfg.normalbae_detect_resolution)
            if not cfg.normalbae_weights_path:
                dreammat_tpu_torch.warn(
                    "normal control type: no normalbae_weights_path given; the NormalBae "
                    "detector runs with random weights ('self-normal' uses the renderer's "
                    "normals)")
        if "hed" in cfg.control_types:
            self._hed = load_hed(cfg.hed_weights_path or None, self.device)
            if not cfg.hed_weights_path:
                dreammat_tpu_torch.warn(
                    "hed control type: no hed_weights_path given; the HED detector runs with "
                    "random weights")

    def _image_conditions(self, condition_map, rgb=None):
        """Per control type, at guidance resolution; condition_map [B,C,h,w],
        rgb [B,3,H,W] in [0,1]."""
        if condition_map is None and rgb is None:
            return None
        prep = self._prep_condition
        cfg = self.cfg
        out = []
        for ct in cfg.control_types:
            if ct == "canny":
                out.append(prep(soft_canny(rgb, cfg.canny_lower_bound, cfg.canny_upper_bound)))
            elif ct == "depth":
                out.append(prep(condition_map[:, 0:1], want_channels=3))
            elif ct == "self-normal":
                out.append(prep(condition_map[:, 1:4]))
            elif ct == "normal":
                out.append(prep(self._normalbae.detect(rgb.float())))
            elif ct == "hed":
                out.append(prep(self._hed.detect(rgb.float(), scribble=True)))
            elif ct == "light":
                out.append(prep(condition_map))
            else:
                raise ValueError(f"unsupported control type {ct}")
        return out
