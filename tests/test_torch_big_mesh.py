"""Port parity: DreamMat on a mesh above ``DENSE_CAST_MAX_TRIS`` triangles.

Both packages send every cast of a mesh above the threshold to the BVH
walk (the JAX package's ``cast_rays``, the port's ``cast_rays_bvh``:
kernel E on the card, ``cast_rays_bvh_plain`` here). A 2^22-triangle mesh
is out of reach of a CPU test, so the threshold is lowered in both
packages (``LIMIT``, under the tiny torus's 576 triangles) and the JAX
caches are cleared before and after, so that no trace keeps either
threshold. On the tiny DreamMat config, on that torus (one fixed view,
8 x 8 visibility bins, prefiltered tables):

- the prerender's G-buffers: masks, pixel indices and face ids equal, depth
  and the other floats within relative L2 1e-4 (as
  ``tests/test_torch_prerender.py``);
- the baked vertex-visibility table: at most 1e-3 of its bins differ (bake
  rays that graze an edge; see ``tests/test_torch_bvh.py``);
- the fast-path gate: colour RMSE and gradient cosine within 1e-3 of the
  JAX package's, on the JAX package's table and with its weights W (as
  ``tests/test_torch_fastpath.py``), and the same decision;
- the export's texel bake on the torus's own (u, v) layout at 64^2: hits
  and faces equal on all but at most 1e-3 of the texels, u and v within
  1e-5 where the faces agree.

The port's casts are shown to walk: the renderer keeps the packed BVH and
not the plane data, and the dense casters of both packages are not called.
Then main path 13's CPU form (``chip_smoke.drive_big_mesh`` at size
``tiny``) runs end to end and writes its files.
"""

import jax
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.data  # noqa: F401
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.data import prerender as jpr
from dreammat_tpu.models import exporter as jexp
from dreammat_tpu.ops import bvh as jbvh
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.data import prerender as tpr
from dreammat_tpu_torch.models import exporter as texp
from dreammat_tpu_torch.models.mesh import torus_arrays, torus_uv_arrays, write_obj
from dreammat_tpu_torch.ops import bvh as tbvh
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

LIMIT = 256  # the lowered DENSE_CAST_MAX_TRIS; the torus has 576 triangles
TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


class GivenDraws:
    def __init__(self, arrays):
        self.arrays = arrays

    def uniform(self, name, shape):
        x = self.arrays[name]
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return torch.from_numpy(np.array(x))


def _no_dense(*a, **k):
    raise AssertionError("a dense caster ran on a mesh above the threshold")


@pytest.fixture(scope="module")
def walking():
    """Both packages' threshold at ``LIMIT`` and their dense casters
    refused, for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbvh, tbvh):
            mp.setattr(mod, "DENSE_CAST_MAX_TRIS", LIMIT)
        for name in ("cast_rays_plane", "cast_rays_dense", "cast_rays_dense_pallas"):
            mp.setattr(jbvh, name, _no_dense)
        for name in ("cast_rays_plain", "cast_rays_dense"):
            mp.setattr(tbvh, name, _no_dense)
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def pair(walking, tmp_path_factory):
    obj = write_obj(str(tmp_path_factory.mktemp("torus") / "torus.obj"), *torus_arrays())
    overrides = [
        "system.prompt_processor.prompt=a torus",
        f"system.geometry.shape_init=mesh:{obj}",
        "system.material.use_prefiltered=true",
        "data.fix_view_num=1",
        "system.renderer.visibility_oct_res=8",
        "data.fastpath_check=false",
        "data.static_field_maps=false",
    ]
    jcfg = jload("configs/dreammat_tiny.yaml", overrides)
    tcfg = tload("configs/dreammat_tiny.yaml", overrides)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")
    own_table = tsys.material.baked_visibility.table
    jb = jsys.material.baked_visibility
    tsys.material.set_baked_visibility(
        BakedVisibility(torch.as_tensor(np.asarray(jb.table)), jb.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    return jsys, jdm, tsys, tdm, own_table


def test_renderer_walks(pair):
    _, _, tsys, _, _ = pair
    ren = tsys.renderer
    assert ren.bvh.tri_v0.shape[0] > LIMIT and tbvh.uses_walk(ren.bvh)
    assert isinstance(ren.tri_data, tbvh.PackedBVH)  # no plane data made


def test_gbuffers(pair):
    _, jdm, _, tdm, _ = pair
    for jg, tg in zip(jdm.data.gbuffers, tdm.data.gbuffers):
        for name in ("mask", "fg_idx", "fg_valid", "fg_tri"):
            assert np.array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name))), name
        for name in ("fg_pos", "fg_normal", "fg_bary"):
            assert _rel(getattr(tg, name).numpy(), getattr(jg, name)) < TOL, name
        assert _rel(tg.cn_depth.float().numpy(), np.asarray(jg.cn_depth, np.float32)) < TOL


def test_baked_vertex_visibility(pair):
    jsys, _, _, _, own_table = pair
    differ = own_table.numpy() != np.asarray(jsys.material.baked_visibility.table)
    print(f"{int(differ.sum())} of {differ.size} bins differ")
    assert differ.mean() <= 1e-3, int(differ.sum())


def test_gate_measures_and_decision(pair):
    jsys, jdm, tsys, tdm, _ = pair
    mat_cls, grad = type(jsys.material), jax.grad
    with pytest.MonkeyPatch.context() as mp:  # the JAX gate jitted (eager, it takes minutes)
        mp.setattr(mat_cls, "shade_raytracing", jax.jit(
            mat_cls.shade_raytracing, static_argnums=(0, 9)))
        mp.setattr(jax, "grad", lambda f, *a, **k: jax.jit(grad(f, *a, **k)))
        rmse_j = jpr.fastpath_residual(jsys.renderer, jsys.material, jdm.data)
        gc_j = jpr.fastpath_grad_cos(jsys.renderer, jsys.material, jdm.data)
    rmse_t = tpr.fastpath_residual(tsys.renderer, tsys.material, tdm.data)
    GP = min(4096, tdm.data.gbuffers[0].fg_pos.shape[0])
    W = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (GP, 3)))
    gc_t = tpr.fastpath_grad_cos(tsys.renderer, tsys.material, tdm.data,
                                 draws=GivenDraws({"gate_w": W}))
    assert abs(rmse_t - rmse_j) <= 1e-3, (rmse_t, rmse_j)
    assert abs(gc_t - gc_j) <= 1e-3, (gc_t, gc_j)
    cfg = tdm.cfg
    keep = lambda rmse, gc: rmse <= cfg.fastpath_rmse_threshold and gc >= \
        cfg.fastpath_grad_cos_threshold
    assert keep(rmse_t, gc_t) == keep(rmse_j, gc_j), (rmse_t, gc_t, rmse_j, gc_j)


def test_texel_bake(walking):
    vt, ft = torus_uv_arrays()
    vt = vt * 0.9 + 0.05  # off the square's edges, as an unwrap's padding leaves it
    ref = jexp.rasterize_uv_texels(vt, ft, 64)
    bvh, o, d = texp.uv_texel_rays(vt, ft, 64, device="cpu")
    assert tbvh.uses_walk(bvh)
    got = texp.rasterize_uv_texels(vt, ft, 64, device="cpu")
    differ = (got["face"].numpy() != np.asarray(ref["face"])) | \
        (got["hit"].numpy() != np.asarray(ref["hit"]))
    assert differ.mean() <= 1e-3, int(differ.sum())
    same = ~differ & got["hit"].numpy()
    assert same.mean() > 0.7
    for k in ("u", "v"):
        assert np.abs(got[k].numpy()[same] - np.asarray(ref[k])[same]).max() <= 1e-5, k


def test_path_13_cpu_form(walking, tmp_path):
    import chip_smoke

    res = chip_smoke.drive_big_mesh(str(tmp_path / "big"), device="cpu", size="tiny")
    assert res["triangles"] == 576 and res["dense"] == 0
    assert set(res["walk_by_stage"]) == {"gbuffers", "vertex_bake", "gate", "test_renders",
                                         "texel_bake"}
    assert all(n > 0 for n in res["walk_by_stage"].values())
    assert res["obj_counts"] == {"v": res["vertices"], "vt": res["vertices"],
                                 "vn": res["vertices"], "f": 576}
    assert res["gate"]["rmse"] is not None and all(np.isfinite(res["losses"]))
