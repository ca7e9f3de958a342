"""Port parity: the material field and the tables-regime shading.

The same numpy inputs go through the JAX hash grid, geometry, material and
split-sum table shading and through their ports (relative L2 1e-5, fp32
on the CPU); the hash-grid table gradient is compared too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreammat_tpu.models.geometry import DreamMatMesh as JMesh
from dreammat_tpu.models.material import DreamMatMaterial as JMaterial
from dreammat_tpu.models.material import material_smoothness_grad as j_smooth
from dreammat_tpu.ops import hashgrid as jhg
from dreammat_tpu_torch.models.diffusion.convert import geometry_params_from_numpy
from dreammat_tpu_torch.models.geometry import DreamMatMesh as TMesh
from dreammat_tpu_torch.models.material import DreamMatMaterial as TMaterial
from dreammat_tpu_torch.models.material import material_smoothness_grad as t_smooth
from dreammat_tpu_torch.ops import hashgrid as thg
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# 12-bit table: the coarse levels index densely, the fine ones hash
HG = dict(n_levels=8, n_features_per_level=2, log2_hashmap_size=12, base_resolution=4,
          per_level_scale=1.6)


def test_hashgrid_values_and_table_grad():
    jcfg = jhg.HashGridConfig(**HG)
    tcfg = thg.HashGridConfig(**HG)
    rng = np.random.RandomState(0)
    table = rng.uniform(-1, 1, size=(8, 1 << 12, 2)).astype(np.float32)
    pts = rng.uniform(0, 1, size=(700, 3)).astype(np.float32)
    pts[:5] = [1.0, 0.0, 0.5]  # upper edge of the grid
    r = rng.normal(size=(700, 16)).astype(np.float32)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(pts), jcfg))
    gref = np.asarray(jax.grad(lambda t: jnp.sum(
        jhg.hashgrid_encode(t, jnp.asarray(pts), jcfg) * r))(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = thg.hashgrid_encode(tt, torch.from_numpy(pts), tcfg)
    (got * torch.from_numpy(r)).sum().backward()
    assert _rel(got.detach().numpy(), ref) < TOL
    assert _rel(tt.grad.numpy(), gref) < TOL


def _geo_cfg():
    return {"shape_init": "procedural:sphere", "shape_init_params": 1,
            "pos_encoding_config": {"otype": "HashGrid", **HG}}


def test_geometry_apply_with_carried_params():
    jg = JMesh(_geo_cfg())
    params = jg.init(jax.random.PRNGKey(0))
    tg = TMesh(_geo_cfg(), device="cpu")
    field = tg.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    pts = np.random.RandomState(1).uniform(-1.2, 1.2, size=(300, 3)).astype(np.float32)
    ref = np.asarray(jg.apply(params, jnp.asarray(pts)))
    got = tg.apply(field, torch.from_numpy(pts)).detach().numpy()
    assert _rel(got, ref) < TOL
    assert np.allclose(tg.mesh.v_pos.numpy(), np.asarray(jg.mesh.v_pos))
    assert np.allclose(tg.mesh.v_nrm.numpy(), np.asarray(jg.mesh.v_nrm), atol=1e-6)


@pytest.fixture(scope="module")
def materials():
    cfg = {"environment_texture": "/nonexistent", "n_environments": 2, "env_height": 32,
           "env_width": 64, "use_prefiltered": True, "environment_scale": 2.0}
    return JMaterial(cfg), TMaterial(cfg, device="cpu")


def test_envs_and_fg_lut(materials):
    jm, tm = materials
    assert _rel(tm.envs.numpy(), np.asarray(jm.envs)) < TOL
    assert _rel(tm.fg_lut.numpy(), np.asarray(jm.fg_lut)) < TOL


def test_features_to_material_and_smoothness(materials):
    jm, tm = materials
    rng = np.random.RandomState(2)
    f = rng.normal(size=(200, 5)).astype(np.float32) * 2
    fj = f + rng.normal(size=(200, 5)).astype(np.float32) * 0.1
    for a, b in zip(tm.features_to_material(torch.from_numpy(f)),
                    jm.features_to_material(jnp.asarray(f))):
        assert _rel(a.numpy(), b) < TOL
    got = float(t_smooth(torch.from_numpy(f), torch.from_numpy(fj)))
    ref = float(j_smooth(jnp.asarray(f), jnp.asarray(fj)))
    assert abs(got - ref) <= TOL * abs(ref)


def test_shade_prefiltered(materials):
    jm, tm = materials
    rng = np.random.RandomState(3)
    P, V = 300, 50
    n = rng.normal(size=(P, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vd = n + rng.normal(size=(P, 3)).astype(np.float32) * 0.5
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    metallic = rng.uniform(0, 0.9, size=(P, 1)).astype(np.float32)
    rough_sq = rng.uniform(0.0, 1.0, size=(P, 1)).astype(np.float32)
    albedo = rng.uniform(size=(P, 3)).astype(np.float32)
    table = rng.uniform(0, 2, size=(V, 6, 3)).astype(np.float32)
    tri = rng.randint(0, V, size=(P, 3))
    bary = rng.dirichlet([1, 1, 1], size=P).astype(np.float32)
    ref = jm.shade_prefiltered(*(jnp.asarray(a) for a in (n, vd, metallic, rough_sq, albedo,
                                                           table)),
                               vis_data=(jnp.asarray(tri), jnp.asarray(bary)))
    got = tm.shade_prefiltered(*(torch.from_numpy(a) for a in (n, vd, metallic, rough_sq,
                                                                albedo, table)),
                               vis_data=(torch.from_numpy(tri), torch.from_numpy(bary)))
    for k in got:
        assert _rel(got[k].numpy(), ref[k]) < TOL, k
