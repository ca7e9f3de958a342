"""Port parity: Magic123, image-conditioned DreamFusion and the Zero123
refinement against JAX.

Each case builds the JAX and the port system from ``configs/zero123_tiny.yaml``
with the same weights (the SD guidance's, the Zero123 guidance's through
``carry_zero123``), prompt embeddings and initial scene, hands the port the
JAX ``fit``'s draws by name (the Zero123 guidance's of Magic123 under the
prefix ``guidance_3d/``) and runs one step of ``fit`` on both:

- ``image-condition-dreamfusion-system`` (the Zero123 step with the
  prompted SD guidance) and ``magic123-system``'s volume stage (both
  guidances on one view, the mask's cross-entropy, the 2D normal
  smoothness): every loss term to relative 1e-4, the scene's moves to
  relative L2 0.05;
- the refinement stages of ``zero123-system`` and ``magic123-system``
  (DMTet at resolution 12 and the rasterizer, the JAX hit pass's slots
  handed over as in ``tests/test_torch_dmtet_systems.py``; a small lattice
  keeps the JAX edge ids clear of their int32 wrap): every loss term to
  relative 1e-4, the SDF's and the deformation's gradients within 1e-3 of
  the largest (from the JAX step's Adam moment) and the updated SDF and
  deformation within 1e-5 wherever the gradient is above 1e-6 of the
  largest. The silhouette takes one SDF sample a ray
  (``sdf_opacity_samples: 1``): over several, the jitted JAX step breaks
  near-ties of their max otherwise than the eager JAX package, which the
  port follows (on this run's reference rays the port's opacity gradient
  is 4e-8 of the largest from the eager JAX's and 0.22 from the jitted
  one's at 8 samples; 5e-7 from the jitted one's at 1 sample), and the
  reference view's mask and colour terms send every silhouette ray's
  gradient through that max.
"""

import jax
import numpy as np
import pytest

from dreammat_tpu_torch.models.mesh_rasterizer import MeshRasterizer

from test_torch_dmtet_systems import _given_hits
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401
from test_torch_zero123 import (
    Z123_TINY, compare_step, image_overrides, step_keys, system_pair, volume_draws,
    write_inputs, zero123_draws,
)

SD_TINY = ["system.guidance_type=stable-diffusion-guidance",
           "system.guidance!={model_size: tiny, half_precision_weights: false, width: 24, "
           "height: 24, cache_dir: null, guidance_scale: 100.0}",
           "system.prompt_processor!={model_size: tiny, prompt: a red apple, use_cache: false}"]
# the reference camera off the lattice's axes: a camera on an axis sends rays
# through the lattice's edges, where the two packages' float32 rays (1e-7
# apart) may take the hit on either side
# (one silhouette sample: see the module's docstring)
DMTET = ["system.refinement=true", "data.default_elevation_deg=7.0",
         "data.default_azimuth_deg=13.0",
         "system.geometry!={radius: 1.0, isosurface_resolution: 12, max_crossing_tets: 2048, "
         "shape_init: sphere, shape_init_params: 0.55, n_feature_dims: 3, pos_encoding_config: "
         "{otype: HashGrid, n_levels: 2, n_features_per_level: 2, log2_hashmap_size: 8, "
         "base_resolution: 4, per_level_scale: 1.5}, mlp_network_config: {n_neurons: 8, "
         "n_hidden_layers: 1}}",
         "system.renderer!={radius: 1.0, sdf_opacity_samples: 1}",
         "system.material_type=no-material", "system.material!={n_output_dims: 3}"]


@pytest.fixture(scope="module")
def cond_png(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("m123"))


def magic123_overrides(cond_png):
    return SD_TINY + [
        "system_type=magic123-system",
        "system.guidance_3d!={model_size: tiny, half_precision_weights: false, width: 24, "
        f"height: 24, cond_image_path: {cond_png}, guidance_scale: 5.0, cache_dir: null}}"]


def sd_draws(k, lat_hw):
    """The draws of the JAX SD guidance's key ``k`` (split as there)."""
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    keys = jax.random.split(k, 3)
    lat = (1, *lat_hw, 4)
    return {"vae_eps": nchw(jax.random.normal(keys[0], lat)),
            "t": jax.random.uniform(keys[1], (1,)), "noise": nchw(jax.random.normal(keys[2], lat))}


RUNS = {
    "image_condition_dreamfusion": ["system_type=image-condition-dreamfusion-system"] + SD_TINY,
    "magic123": ["system.loss!={lambda_sds: 0.025, lambda_3d_sds: 1.0, lambda_rgb: 1000.0, "
                 "lambda_mask: 100.0, lambda_orient: 1.0, lambda_normal_smoothness_2d: 0.5}"],
}


@pytest.mark.parametrize("run", list(RUNS))
def test_volume_step_matches_jax(tmp_path, cond_png, run):
    over = image_overrides(cond_png, tmp_path, zero123=False) + RUNS[run]
    if run == "magic123":
        over += magic123_overrides(cond_png)
    system_type = "magic123-system" if run == "magic123" else \
        "image-condition-dreamfusion-system"
    pair = system_pair(Z123_TINY, over, system_type)
    jsys, jdm, tsys, tdm, state0 = pair
    k = step_keys()
    n = tdm.cfg.height * tdm.cfg.width
    f = tsys.guidance.vae_factor
    if run == "magic123":
        k_ref, _, k_g2, k_g3 = jax.random.split(k, 4)
        d = volume_draws(jsys, tdm, k_ref, k, 2 * n)
        d.update(sd_draws(k_g2, (24 // f, 24 // f)))
        d.update(zero123_draws(k_g3, (24 // f, 24 // f), prefix="guidance_3d/"))
    else:
        k_ref, _, k_guide = jax.random.split(k, 3)
        d = volume_draws(jsys, tdm, k_ref, k, 2 * n)
        d.update(sd_draws(k_guide, (24 // f, 24 // f)))
    _, losses = compare_step(tmp_path, *pair, d)
    want = ("loss_sds", "loss_3d_sds", "loss_normal_smoothness_2d", "loss_orient") \
        if run == "magic123" else ("loss_sds", "loss_rgb", "loss_opaque")
    assert all(losses.get(key) for key in want), losses
    assert type(tsys.guidance).__name__ == "StableDiffusionGuidance"


@pytest.mark.parametrize("system_type", ["zero123-system", "magic123-system"])
def test_refinement_step_matches_jax(tmp_path, monkeypatch, cond_png, system_type):
    magic = system_type == "magic123-system"
    over = image_overrides(cond_png, tmp_path, zero123=not magic) + DMTET
    if magic:
        over += magic123_overrides(cond_png) + [
            "system.loss!={lambda_sds: 0.025, lambda_3d_sds: 1.0, lambda_rgb: 1000.0, "
            "lambda_mask: 100.0, lambda_normal_consistency: 100.0, "
            "lambda_laplacian_smoothness: 10.0}"]
    else:
        over.append("system.loss.lambda_normal_consistency=100.0")
    pair = system_pair(Z123_TINY, over, system_type)
    jsys, jdm, tsys, tdm, state0 = pair
    assert type(tsys.renderer).__name__ == "MeshRasterizer"
    assert type(tsys.geometry).__name__ == "TetrahedraSDFGrid"
    state0["geo"]["sdf"] = state0["geo"]["sdf"] + np.random.RandomState(1).normal(
        0, 0.01, state0["geo"]["sdf"].shape).astype(np.float32)
    monkeypatch.setattr(MeshRasterizer, "_cast", _given_hits(jsys))
    k = step_keys()
    f = tsys.guidance.vae_factor
    lat = (24 // f, 24 // f)
    if system_type == "magic123-system":
        _, _, k_g2, k_g3 = jax.random.split(k, 4)
        d = {**sd_draws(k_g2, lat), **zero123_draws(k_g3, lat, prefix="guidance_3d/")}
    else:
        d = zero123_draws(jax.random.split(k, 3)[2], lat)
    jstate, losses = compare_step(tmp_path, *pair, d, moves=False)
    assert losses["loss_normal_consistency"] > 0 and losses["loss_rgb"] > 0
    if system_type == "magic123-system":
        assert losses["loss_laplacian_smoothness"] > 0 and losses["loss_3d_sds"] > 0
    geo = tsys.field.geo
    for name in ("sdf", "deformation"):
        p = getattr(geo, name)
        g_j = np.asarray(jstate["opt"][0].mu["geo"][name]) / 0.1  # Adam's first moment, step 1
        g_t, new_t, new_j = p.grad.numpy(), p.detach().numpy(), np.asarray(jstate["geo"][name])
        big = np.abs(g_j).max()
        assert big > 0 and np.abs(new_t - state0["geo"][name]).max() > 0, name
        assert np.abs(g_t - g_j).max() <= 1e-3 * big, (name, np.abs(g_t - g_j).max(), big)
        held = np.abs(g_j) > 1e-6 * big
        assert held.sum() > 100, (name, held.sum())
        assert np.abs(new_t - new_j)[held].max() <= 1e-5, name
