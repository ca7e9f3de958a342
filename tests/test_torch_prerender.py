"""Port parity: G-buffers, bakes, condition maps and light tables.

The tiny DreamMat config (icosphere level 2, 32^2 renders, two views, two
environments, condition maps resized to 16^2 so the antialiased resize
runs) goes through the JAX prerender and the port's. Masks, pixel indices
and face ids must be equal; the float outputs agree to relative L2 1e-4.

The per-vertex visibility bake casts rays from just above each vertex, so
a few of them graze an edge of a neighbouring triangle; there the hit test
depends on the order of the fp32 sums, which XLA and PyTorch choose
differently. Those bins may differ (at most 1e-3 of them), and everything
downstream of the table is compared on the same table: the port's material
is handed the JAX package's table before its prerender runs.
"""

import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.data  # noqa: F401
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


TOL = 1e-4
OVERRIDES = [
    "system.prompt_processor.prompt=a red apple",
    "system.geometry.shape_init=procedural:sphere",
    "system.geometry.shape_init_params=2",
    "system.material.use_prefiltered=true",
    "data.fix_view_num=2",
    "data.cond_height=16",
    "data.cond_width=16",
    "data.fastpath_check=false",
    "data.static_field_maps=false",
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def pair():
    jcfg = jload("configs/dreammat_tiny.yaml", OVERRIDES)
    tcfg = tload("configs/dreammat_tiny.yaml", OVERRIDES)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")
    own_table = tsys.material.baked_visibility.table
    tsys.material.set_baked_visibility(BakedVisibility(
        torch.as_tensor(np.asarray(jsys.material.baked_visibility.table)),
        jsys.material.baked_visibility.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    return jsys, jdm, tsys, tdm, own_table


def test_gbuffers(pair):
    _, jdm, _, tdm, _ = pair
    for jg, tg in zip(jdm.data.gbuffers, tdm.data.gbuffers):
        for name in ("mask", "fg_idx", "fg_valid", "fg_tri"):
            assert np.array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name))), name
        for name in ("fg_pos", "fg_normal", "fg_viewdir", "fg_bary"):
            assert _rel(getattr(tg, name).numpy(), getattr(jg, name)) < TOL, name
        for name in ("cn_depth", "cn_normal"):
            assert _rel(getattr(tg, name).float().numpy(),
                        np.asarray(getattr(jg, name), np.float32)) < TOL, name


def test_baked_visibility_and_self_occlusion(pair):
    from dreammat_tpu.ops.visibility import self_occlusion_fraction as jocc
    from dreammat_tpu_torch.ops.visibility import self_occlusion_fraction as tocc

    jsys, _, tsys, _, own_table = pair
    jb = jsys.material.baked_visibility
    tb = BakedVisibility(own_table, jb.oct_res)
    differ = tb.table.numpy() != np.asarray(jb.table)
    assert differ.mean() <= 1e-3, differ.sum()
    occ_t = tocc(tb, tsys.renderer.mesh.v_nrm)
    occ_j = jocc(jb, jsys.renderer.mesh.v_nrm)
    assert abs(occ_t - occ_j) <= differ.mean() * tb.table.shape[1]
    assert occ_t < 0.01  # the sphere is convex: the fast-path check is skipped


def test_condition_maps_and_probes(pair):
    _, jdm, _, tdm, _ = pair
    j, t = jdm.data, tdm.data
    for name in ("depths", "normals", "lightmaps"):
        a = getattr(t, name).float().numpy()
        b = np.asarray(getattr(j, name), np.float32)
        assert a.shape == b.shape, name
        assert _rel(a, b) < TOL, name
    assert t.lightmaps.shape[-1] == 18


def test_light_tables(pair):
    _, jdm, _, tdm, _ = pair
    j, t = jdm.data, tdm.data
    assert _rel(t.table_diff.numpy(), j.table_diff) < TOL
    assert _rel(t.table_spec.float().numpy(), np.asarray(j.table_spec, np.float32)) < TOL
    assert _rel(t.lvis.float().numpy(), np.asarray(j.lvis, np.float32)) < TOL


def test_collate_matches(pair):
    _, jdm, _, tdm, _ = pair
    jdm.rng = np.random.RandomState(11)
    tdm.rng = np.random.RandomState(11)
    for step in range(3):
        jb, tb = jdm.collate(step), tdm.collate(step)
        assert (jb["view_id"], int(jb["env_id"])) == (tb["view_id"], tb["env_id"])
        assert _rel(tb["condition_map"][0].permute(1, 2, 0).numpy(), jb["condition_map"][0]) < TOL
        assert _rel(tb["light_table"].numpy(), jb["light_table"]) < TOL
        assert float(tb["elevation"][0]) == float(jb["elevation"][0])


def test_inverse_normalize_depth():
    from dreammat_tpu.data.prerender import _inverse_normalize_depth as jf
    from dreammat_tpu_torch.data.prerender import _inverse_normalize_depth as tf

    d = np.random.RandomState(0).uniform(0, 4, size=(16, 16)).astype(np.float32)
    d[d < 1] = 0
    assert np.allclose(tf(d), jf(d))
