"""Port parity of the scaffold: configs, schedules, prompts, cameras, helpers.

The port keeps its own copies of the JAX package's pure-Python pieces
(config, tokenizer) and rewrites the small numeric helpers in torch. Here
the same inputs go through both: configs must resolve to equal trees, the
step schedules and prompt buckets must agree at every step and angle the
DreamMat configs reach, and the camera and shading helpers to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreammat_tpu.data import cameras as jcam
from dreammat_tpu.models.diffusion.tokenizer import CLIPTokenizer as JTokenizer
from dreammat_tpu.models.prompt import PromptEmbeddings as JPrompt
from dreammat_tpu.utils import ops as jops
from dreammat_tpu.utils.config import config_to_primitive as jprim
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu.utils.schedule import C_jax
from dreammat_tpu_torch.data import cameras as tcam
from dreammat_tpu_torch.models.diffusion.tokenizer import CLIPTokenizer as TTokenizer
from dreammat_tpu_torch.models.prompt import PromptEmbeddings as TPrompt
from dreammat_tpu_torch.utils import ops as tops
from dreammat_tpu_torch.utils.config import config_to_primitive as tprim
from dreammat_tpu_torch.utils.config import load_config as tload
from dreammat_tpu_torch.utils.schedule import C

OVERRIDES = [
    "system.prompt_processor.prompt=a red apple",
    "system.geometry.shape_init=procedural:sphere",
    "system.geometry.shape_init_params=6",
]
STEPS = [0, 1, 250, 499, 500, 501, 700, 701, 1000, 1999, 2000, 2001, 30000]


@pytest.mark.parametrize("path", ["configs/dreammat.yaml", "configs/dreammat_tiny.yaml"])
def test_configs_resolve_to_equal_trees(path):
    j = jprim(jload(path, OVERRIDES, timestamp=""))
    t = tprim(tload(path, OVERRIDES, timestamp=""))
    assert t == j


@pytest.mark.parametrize("value", [1.05, 0.0, [0, -1.0, -0.5, 2000], [0, 0.0, -0.5, 2000],
                                   [500, 0.2, 0.02, 501], [500, 0.8, 0.5, 501],
                                   [0.3, 0.1, 100]])
def test_schedule_matches_c_jax(value):
    for step in STEPS:
        assert abs(C(value, step) - float(C_jax(value, step))) <= 1e-6, step


@pytest.mark.parametrize("pct", [[500, 0.2, 0.02, 501], [500, 0.8, 0.5, 501], 0.02, 0.98])
def test_timestep_window_matches(pct):
    """The guidance's scheduled [min_step, max_step] (guidance.py:303-308)."""
    for step in STEPS:
        got = int(round(1000 * C(pct, step)))
        ref = int(jnp.round(1000 * C_jax(pct, step)).astype(jnp.int32))
        assert got == ref, step


def test_condition_scale_anneal_matches():
    import dreammat_tpu
    import dreammat_tpu.models  # noqa: F401
    import dreammat_tpu_torch

    cfg = {"model_size": "tiny", "control_anneal_start_step": 700,
           "condition_scales": [1.0], "condition_scales_anneal": [0.8]}
    jg = dreammat_tpu.find("stable-diffusion-dreammat-guidance")(cfg)
    tg = dreammat_tpu_torch.find("stable-diffusion-dreammat-guidance")(cfg, device="cpu")
    for step in STEPS:
        assert tg.condition_scales_at(step) == pytest.approx(
            [float(s) for s in jg.condition_scales_at(jnp.int32(step))]), step


def test_prompt_direction_buckets_match():
    el, az = np.meshgrid(np.linspace(-30, 90, 25), np.linspace(-400, 400, 81))
    el, az = el.ravel().astype(np.float32), az.ravel().astype(np.float32)
    z = np.zeros((4, 1, 1), np.float32)
    jp = JPrompt(z, z, z[0], z[0], z[0])
    tp = TPrompt(*(torch.from_numpy(x) for x in (z, z, z[0], z[0], z[0])))
    ref = np.asarray(jp.direction_idx(jnp.asarray(el), jnp.asarray(az)))
    got = tp.direction_idx(torch.from_numpy(el), torch.from_numpy(az)).numpy()
    assert np.array_equal(got, ref)


def test_tokenizer_copy_matches():
    prompts = ["a red apple", "", "oversaturated color, ugly, tiling, poorly drawn hands",
               "A Wooden CHAIR, side view", "x" * 400]
    for vocab_dir in (None, "model/tokenizer"):
        j = JTokenizer(vocab_dir=vocab_dir).batch(prompts)
        t = TTokenizer(vocab_dir=vocab_dir).batch(prompts)
        assert np.array_equal(np.asarray(t), np.asarray(j))


def test_fixed_cameras_match():
    kw = dict(elevation_range=(-20.0, 45.0), azimuth_range=(-180.0, 180.0),
              camera_distance_range=(3.0, 4.0), fovy_range=(25.0, 45.0), seed=3)
    j = jcam.make_fixed_cameras(9, **kw)
    t = tcam.make_fixed_cameras(9, **kw)
    for name in ("elevation_deg", "azimuth_deg", "camera_distances", "fovy_deg"):
        assert np.allclose(getattr(t, name), getattr(j, name), atol=1e-6), name


def test_camera_and_shading_helpers_match():
    rng = np.random.RandomState(0)
    el, az = rng.uniform(-20, 45, 16).astype(np.float32), rng.uniform(-180, 180, 16).astype(np.float32)
    dist = rng.uniform(3, 4, 16).astype(np.float32)
    pos_j = jops.camera_position_from_spherical(jnp.asarray(el), jnp.asarray(az), jnp.asarray(dist))
    pos_t = tops.camera_position_from_spherical(*(torch.from_numpy(x) for x in (el, az, dist)))
    assert np.allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-5)
    c2w_j, c2w_t = jops.get_c2w(pos_j), tops.get_c2w(pos_t)
    assert np.allclose(c2w_t.numpy(), np.asarray(c2w_j), atol=1e-5)
    assert np.allclose(tops.get_w2c(c2w_t).numpy(), np.asarray(jops.get_w2c(c2w_j)), atol=1e-4)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    assert np.allclose(tops.get_orthogonal_directions(torch.from_numpy(v)).numpy(),
                       np.asarray(jops.get_orthogonal_directions(jnp.asarray(v))), atol=1e-6)
    assert np.allclose(tops.reflect(torch.from_numpy(v), torch.from_numpy(n)).numpy(),
                       np.asarray(jops.reflect(jnp.asarray(v), jnp.asarray(n))), atol=1e-5)
    x = rng.uniform(-0.5, 2.0, size=(256,)).astype(np.float32)
    assert np.allclose(tops.lin2srgb(torch.from_numpy(x)).numpy(),
                       np.asarray(jops.lin2srgb(jnp.asarray(x))), atol=1e-6)
    for a, b in zip(tops.sample_sphere_fibonacci(200), jops.sample_sphere_fibonacci(200)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-6)
