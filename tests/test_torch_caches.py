"""Port parity: the prerender npz cache and the reference PNG cache.

The tiny DreamMat config (icosphere level 2, two views, two environments,
condition maps at 16^2) is prerendered by both packages into cache
directories of their own; each package's file is then read by the other.

- ``mesh_signature`` is the same in both packages, so both name the file
  alike.
- A file written by the JAX package is read by the port (``from_cache``),
  and its decoded probes, depth and normal maps and specular tables equal
  the JAX package's own decoding of it, exactly.
- A file written by the port (uint8 probes and normals, uint16 depth, f16
  tables) is read by the JAX package without rendering (its probe render
  made to raise), to the port's decoded arrays, exactly; a second port run
  reads back the quantized first run.
- A file without the tables is stale: the port renders anew and rewrites it.
- The reference's Blender PNG cache written by either package loads in
  both to equal arrays, and ``blender_generate`` with
  ``reference_cache_dir`` puts it into the datamodule's condition maps.
"""

import os
import threading

import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.data  # noqa: F401
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.data import prerender as jpr
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.data import prerender as tpr
from dreammat_tpu_torch.utils.config import load_config as tload
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


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
MAPS = ("lightmaps", "depths", "normals", "table_spec")


def _join_jax_writers():
    for t in threading.enumerate():
        if t.name == "prerender-cache-save":
            t.join()


def _only_file(d):
    (name,) = os.listdir(d)
    assert name.startswith("prerender_") and name.endswith(".npz")
    return os.path.join(d, name)


def _decode(path):
    z = np.load(path)
    dec = lambda a, s: (a / np.float32(s)).astype(np.float16)
    return {"lightmaps": dec(z["lightmaps"], 255.0), "depths": dec(z["depths"], 65535.0),
            "normals": dec(z["normals"], 255.0), "table_spec": z["table_spec"]}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    d_jax, d_port = tmp_path_factory.mktemp("jax_cache"), tmp_path_factory.mktemp("port_cache")
    jcfg = jload("configs/dreammat_tiny.yaml", OVERRIDES)
    tcfg = tload("configs/dreammat_tiny.yaml", OVERRIDES)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")

    def jdm(cache):
        dm = dreammat_tpu.find("random-camera-datamodule")(
            dict(jcfg.data, prerender_cache_dir=str(cache)), jsys.renderer, jsys.material)
        dm.setup()
        _join_jax_writers()
        return dm

    def tdm(cache, **over):
        dm = dreammat_tpu_torch.find("random-camera-datamodule")(
            dict(tcfg.data, prerender_cache_dir=str(cache), **over), tsys.renderer,
            tsys.material, device="cpu")
        dm.setup()
        return dm

    out = {"jax_written": jdm(d_jax)}
    out["port_reads_jax"] = tdm(d_jax)
    out["jax_reads_jax"] = jdm(d_jax)
    out["port_written"] = tdm(d_port)
    with pytest.MonkeyPatch.context() as mp:
        def no_render(*a, **k):
            raise AssertionError("the JAX package rendered instead of reading the cache")

        mp.setattr(jpr, "_probe_views_conv", no_render)
        out["jax_reads_port"] = jdm(d_port)
    out["port_reads_port"] = tdm(d_port)
    out.update(jsys=jsys, tsys=tsys, tdm=tdm, d_jax=d_jax, d_port=d_port, cfg=tcfg)
    return out


def test_mesh_signatures_match(caches):
    j, t, cfg = caches["jax_written"], caches["port_written"], caches["cfg"].data
    args = (cfg["height"], cfg["width"], cfg["fix_env_num"])
    sig_j = jpr.mesh_signature(caches["jsys"].renderer.mesh, j.cameras, *args)
    sig_t = tpr.mesh_signature(caches["tsys"].renderer.mesh, t.cameras, *args)
    assert sig_t == sig_j
    assert os.path.basename(_only_file(caches["d_port"])) == f"prerender_{sig_t}.npz"
    assert os.path.basename(_only_file(caches["d_jax"])) == f"prerender_{sig_j}.npz"


def test_port_reads_the_jax_cache(caches):
    t, j = caches["port_reads_jax"], caches["jax_reads_jax"]
    assert t.data.from_cache and not caches["port_written"].data.from_cache
    ref = _decode(_only_file(caches["d_jax"]))
    for name in MAPS:
        got = getattr(t.data, name)
        assert got.dtype == torch.float16, name
        assert np.array_equal(got.numpy(), ref[name]), name
        assert np.array_equal(got.numpy(), np.asarray(getattr(j.data, name))), name


def test_jax_reads_the_port_cache(caches):
    path = _only_file(caches["d_port"])
    z = np.load(path)
    assert {k: z[k].dtype for k in MAPS} == {"lightmaps": np.uint8, "depths": np.uint16,
                                             "normals": np.uint8, "table_spec": np.float16}
    j, t = caches["jax_reads_port"], caches["port_reads_port"]
    assert t.data.from_cache
    for name in MAPS:
        assert np.array_equal(np.asarray(getattr(j.data, name)), getattr(t.data, name).numpy())


def test_cached_run_gets_the_quantized_first_run(caches):
    first, second = caches["port_written"].data, caches["port_reads_port"].data
    q = tpr.quantize_for_cache(first.lightmaps, first.depths, first.normals)
    for name, qx, top in zip(("lightmaps", "depths", "normals"), q, (255.0, 65535.0, 255.0)):
        want = (qx.numpy() / np.float32(top)).astype(np.float16)
        assert np.array_equal(getattr(second, name).numpy(), want), name
        err = (getattr(second, name).float() - getattr(first, name).float()).abs().max().item()
        assert err <= 0.5 / top + 1e-3, name
    assert torch.equal(second.table_spec, first.table_spec)


def test_stale_cache_is_rendered_anew(caches, tmp_path):
    name = os.path.basename(_only_file(caches["d_port"]))
    np.savez(tmp_path / name, lightmaps=np.zeros(3, np.uint8))
    dm = caches["tdm"](tmp_path)
    assert not dm.data.from_cache
    tpr._wait_for_writer(str(tmp_path / name))
    assert "table_spec" in np.load(tmp_path / name)


def _png_inputs(n_views=2, n_envs=2, h=16, w=16, seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2.0, 4.0, (n_views, h, w)).astype(np.float32)
    depth[:, :3] = 0.0  # background rows
    return (rng.random((n_views, n_envs, h, w, 18), dtype=np.float32), depth,
            rng.random((n_views, h, w, 3), dtype=np.float32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_png_cache_round_trip(tmp_path, writer):
    lm, d, n = _png_inputs()
    (tpr if writer == "port" else jpr).write_reference_png_cache(str(tmp_path), lm, d, n)
    got = tpr.load_reference_png_cache(str(tmp_path), 2, 2, 16, 16)
    ref = jpr.load_reference_png_cache(str(tmp_path), 2, 2, 16, 16)
    for g, r in zip(got, ref):
        assert g.dtype == np.float16 and np.array_equal(g, r)
    assert np.abs(got[0].astype(np.float32) - lm).max() <= 0.5 / 255 + 1e-3
    assert np.abs(got[2].astype(np.float32) - n).max() <= 0.5 / 255 + 1e-3
    fg = d > 0
    assert np.all(got[1][..., 0][~fg] == 0) and np.all(got[1][..., 0][fg] >= 0.29)


def test_blender_cache_feeds_the_condition_maps(caches, tmp_path):
    lm, d, n = _png_inputs(seed=1)
    tpr.write_reference_png_cache(str(tmp_path / "ref"), lm, d, n)
    dm = caches["tdm"](tmp_path / "npz", blender_generate=True,
                       reference_cache_dir=str(tmp_path / "ref"))
    want = tpr.load_reference_png_cache(str(tmp_path / "ref"), 2, 2, 16, 16)
    for name, w in zip(("lightmaps", "depths", "normals"), want):
        assert np.array_equal(getattr(dm.data, name).numpy(), w), name
    batch = dm.collate(0)
    assert batch["condition_map"].shape == (1, 22, 16, 16)
