"""The unified guidance names: SDS and VSD behind one config surface.

Counterpart of ``dreammat_tpu/models/guidance_unified.py``. The reference's
``stable-diffusion-unified-guidance`` and ``zero123-unified-guidance`` are
single classes branching on ``guidance_type`` ("sds" | "vsd"); here, as in
the JAX package, each name is a factory that reads the unified config,
translates its keys and builds the registered guidance of that mode
(``stable-diffusion-guidance`` / ``stable-diffusion-vsd-guidance``,
``zero123-guidance`` / ``zero123-vsd-guidance``) on ``device``. Keys with
no counterpart are logged and dropped; ``vsd_*`` keys are inert in SDS
mode.
"""

from __future__ import annotations

import dreammat_tpu_torch

_COMMON_KEYS = (
    "pretrained_model_name_or_path", "guidance_scale", "half_precision_weights",
    "min_step_percent", "max_step_percent", "view_dependent_prompting", "weighting_strategy",
    "width", "height", "cache_dir", "model_size",
)
_VSD_MAP = {
    "vsd_guidance_scale_phi": "guidance_scale_lora",
    "vsd_lora_cfg_training": "lora_cfg_training",
    "vsd_lora_n_timestamp_samples": "lora_n_timestamp_samples",
    "vsd_camera_condition_type": "camera_condition_type",
}
_Z123_KEEP = (
    "pretrained_model_name_or_path", "guidance_scale", "half_precision_weights",
    "min_step_percent", "max_step_percent", "cond_image_path", "cond_elevation_deg",
    "cond_azimuth_deg", "cond_camera_distance", "model_size", "width", "height",
)
_Z123_VSD_MAP = {**_VSD_MAP, "vsd_guidance_scale_phi": "guidance_scale_phi"}


def _mode(cfg: dict, what: str) -> str:
    mode = cfg.get("guidance_type", "sds")
    if mode not in ("sds", "vsd"):
        raise ValueError(f"unknown {what} guidance_type {mode!r}")
    return mode


def _translate(cfg: dict, mode: str, keep, vsd_map: dict, grad_clip_key: str, what: str) -> dict:
    out, dropped = {}, []
    for k, v in cfg.items():
        if k == "guidance_type":
            continue
        if k in keep:
            out[k] = v
        elif k == "grad_clip":
            out[grad_clip_key] = v
        elif mode == "vsd" and k in vsd_map:
            out[vsd_map[k]] = v
        elif k.startswith("vsd_") and mode != "vsd":
            continue
        else:
            dropped.append(k)
    if dropped:
        dreammat_tpu_torch.info("%s: ignoring torch-mechanics keys %s", what, dropped)
    return out


@dreammat_tpu_torch.register("stable-diffusion-unified-guidance")
def stable_diffusion_unified_guidance(cfg, device="cuda"):
    cfg = dict(cfg or {})
    mode = _mode(cfg, "unified")
    out = _translate(cfg, mode, _COMMON_KEYS, _VSD_MAP, "grad_clip_val", "unified guidance")
    if isinstance(out.get("grad_clip_val"), (list, tuple)):
        out["grad_clip_val"] = out["grad_clip_val"][1]
    name = "stable-diffusion-vsd-guidance" if mode == "vsd" else "stable-diffusion-guidance"
    return dreammat_tpu_torch.find(name)(out, device=device)


@dreammat_tpu_torch.register("zero123-unified-guidance")
def zero123_unified_guidance(cfg, device="cuda"):
    cfg = dict(cfg or {})
    mode = _mode(cfg, "zero123-unified")
    out = _translate(cfg, mode, _Z123_KEEP, _Z123_VSD_MAP, "grad_clip", "zero123-unified")
    name = "zero123-vsd-guidance" if mode == "vsd" else "zero123-guidance"
    return dreammat_tpu_torch.find(name)(out, device=device)
