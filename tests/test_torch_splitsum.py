"""Port parity: the split-sum environment path (``use_raytracing: false``).

- ``build_splitsum`` on a 16 x 32 environment map, at its own size and
  shrunk to 8 x 16 (the smoothest level is the resized map): the diffuse
  irradiance and every specular level at relative L2 1e-5 of the JAX
  package's (its ``build_splitsum``, jitted).
- The material's shade: both materials (two procedural 16 x 32 skies,
  split-sum stacks at 16 x 32) shade the same pixels from the same raw
  features through ``__call__``, which applies the linear-roughness
  activation; every output and the gradient of a weighted colour sum to
  the features agree to relative L2 1e-5. The port's material builds its
  own stacks (held equal above); the JAX material is handed its jitted
  stacks and the port's FG LUT (the LUT is compared in
  ``test_torch_field_material.py``).
- One train step through the split-sum path is in
  ``test_torch_random_cameras.py`` (``shading`` = ``splitsum``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.models  # noqa: F401
from dreammat_tpu.ops import envmap as jenv
from dreammat_tpu_torch.ops import envmap as tenv
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

MAT = {"environment_texture": "/nonexistent", "n_environments": 2, "env_height": 16,
       "env_width": 32, "diffuse_sample_num": 16, "specular_sample_num": 8,
       "use_raytracing": False, "splitsum_height": 16, "splitsum_width": 32}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


_jbuild = jax.jit(jenv.build_splitsum, static_argnums=(1, 2))


@pytest.mark.parametrize("hw", [(16, 32), (8, 16)])
def test_build_splitsum_matches_jax(hw):
    env = np.random.RandomState(0).gamma(1.0, 1.5, (16, 32, 3)).astype(np.float32)
    j = _jbuild(jnp.asarray(env), *hw)
    t = tenv.build_splitsum(torch.from_numpy(env), *hw)
    assert tuple(t["specular"].shape) == (len(tenv.SPECULAR_LEVELS), *hw, 3)
    assert np.array_equal(t["levels"].numpy(), np.asarray(j["levels"]))
    assert _rel(t["diffuse"].numpy(), j["diffuse"]) < 1e-5
    for m in range(len(tenv.SPECULAR_LEVELS)):
        assert _rel(t["specular"][m].numpy(), j["specular"][m]) < 1e-5, m


def test_shade_splitsum_and_gradients_match_jax():
    tmat = dreammat_tpu_torch.find("dreammat-material")(MAT, device="cpu")
    jmat = dreammat_tpu.find("dreammat-material")(MAT)
    ss = tmat.ensure_splitsum()
    jss = [_jbuild(jmat.envs[i], 16, 32) for i in range(2)]
    jmat.splitsum = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jss)
    jmat.fg_lut = jnp.asarray(tmat.fg_lut.numpy())
    assert _rel(ss["specular"].numpy(), jmat.splitsum["specular"]) < 1e-5

    rng = np.random.RandomState(1)
    P = 64
    n = rng.normal(size=(P, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vdir = n + 0.7 * rng.normal(size=(P, 3)).astype(np.float32)
    vdir /= np.linalg.norm(vdir, axis=-1, keepdims=True)
    feats = (2.0 * rng.normal(size=(P, 5))).astype(np.float32)
    W = rng.uniform(size=(P, 3)).astype(np.float32)
    for env_id in (0, 1):
        def jloss(f):
            out, _ = jmat(jnp.zeros((P, 3)), f, f, jnp.asarray(vdir), jnp.asarray(n),
                          jnp.int32(env_id), jax.random.PRNGKey(0), is_train=False)
            return jnp.sum(out["color"] * W), out

        (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(feats))
        f = torch.from_numpy(feats).requires_grad_(True)
        tout, _ = tmat(torch.zeros(P, 3), f, f, torch.from_numpy(vdir), torch.from_numpy(n),
                       env_id, None, is_train=False)
        (tg,) = torch.autograd.grad(torch.sum(tout["color"] * torch.from_numpy(W)), f)
        for k, v in jout.items():
            assert _rel(tout[k].detach().numpy(), v) < 1e-5, (env_id, k)
        assert _rel(tg.numpy(), jg) < 1e-5, env_id
        assert float(jnp.abs(jg).max()) > 0
