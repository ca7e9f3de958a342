"""Port parity: hybrid MC steps, per-pixel tables and the eval views,
against the JAX package.

Both packages set up the tiny DreamMat config on a small self-occluding
torus (24 x 12 quads, ``test_torch_fastpath.py``'s set-up) with two fixed
views, ``hybrid_mc_every=2`` and per-pixel visibility tables. Tolerances:
the batches' light tables to relative L2 1e-4 and their per-pixel tables
in at least 99.9% equal bins (grazing rays, see ``test_torch_prerender.py``);
the eval views' G-buffer fields and light tables to max relative 1e-4
(padding lanes excluded: the JAX one-camera builder leaves them unmasked)
and the rendered ``comp_rgb`` to 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from dreammat_tpu_torch.models.diffusion.convert import geometry_params_from_numpy
from test_torch_fastpath import setup_pair
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return setup_pair(tmp_path_factory, ["data.fix_view_num=2", "data.hybrid_mc_every=2",
                                         "data.visibility_pixel_tables=true"])


def test_hybrid_and_pixel_batches_match_jax(pair):
    _, jdm, _, tdm = pair
    jdm.rng = np.random.RandomState(11)
    tdm.rng = np.random.RandomState(11)
    for step in range(4):
        jb, tb = jdm.collate(step), tdm.collate(step)
        assert (jb["view_id"], int(jb["env_id"])) == (tb["view_id"], tb["env_id"])
        if step % 2 == 0:
            assert jb["light_table"] is None and tb["light_table"] is None
        else:
            assert _rel(tb["light_table"].numpy(), jb["light_table"]) < 1e-4
        assert tb["pixel_vis"].dtype == torch.float16
        same = tb["pixel_vis"].float().numpy() == np.asarray(jb["pixel_vis"], np.float32)
        assert same.mean() >= 0.999


def test_eval_views_match_jax(pair):
    jsys, jdm, tsys, tdm = pair
    geo = jsys.init_state(jax.random.PRNGKey(0))["geo"]
    tsys.init_state(0)
    tsys.field.load_state_dict(geometry_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, geo)), strict=True)
    for i in (0, 2):
        jb, tb = jdm.eval_view(i), tdm.eval_view(i)
        jg, tg = jb["gbuffer"], tb["gbuffer"]
        for name in ("mask", "fg_idx", "fg_valid", "fg_tri"):
            assert np.array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name))), name
        valid = tg.fg_valid.numpy()
        for name in ("fg_pos", "fg_normal", "fg_viewdir", "fg_bary"):
            a, b = getattr(tg, name).numpy()[valid], np.asarray(getattr(jg, name))[valid]
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name
        for name in ("cn_depth", "cn_normal"):
            a, b = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
            assert a.dtype == b.dtype == np.float32, name
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name
        lt_t, lt_j = tb["light_table"].numpy(), np.asarray(jb["light_table"])
        assert np.abs(lt_t - lt_j).max() <= 1e-4 * np.abs(lt_j).max()
        jout = jsys.renderer.shade_view(geo, jg, jb["env_id"], jax.random.PRNGKey(i),
                                        is_train=False, light_table=jb["light_table"])
        tout = tsys.render(tg, tb["env_id"], tb["light_table"])
        assert np.abs(tout["comp_rgb"].numpy() - np.asarray(jout["comp_rgb"])).max() <= 1e-4
