"""Port parity: the export (unwrap, texel rasterization, inpainting, maps,
OBJ/MTL), the image/gif/JPEG writers, and ``launch_torch.py`` end to end.

The mesh is a small torus (24 x 12 quads). Tolerances:

- ``smart_unwrap``: identical to the JAX package's (the same numpy code);
- ``rasterize_uv_texels`` at 64^2 against the JAX caster: hit and face
  equal on at least 99.9% of texels, u and v to 1e-5 where both hit;
- ``inpaint_padding``: 1e-6;
- the exported uint8 maps (the same field parameters in both packages):
  within 1 LSB on at least 99.9% of texels; the OBJ and MTL text equal
  line for line;
- the writers (PIL encodes), their files read back: PNG equal to the
  array; GIF within 3 LSB mean absolute error a frame on render-like
  frames (a shaded object on white), looping, 30 ms a frame; JPEG (SOI
  and EOI markers) at least 35 dB PSNR and within 1 dB of PIL's own
  quality-75 encoding.

``launch_torch.py --train --device cpu`` runs 2 steps on the torus (hybrid
MC every 2 steps, one test view, a 64^2 texture, a train grid every step,
a validation grid and a checkpoint at step 2) and writes the test PNGs,
the gif and the OBJ/MTL/JPEGs; ``--export --resume`` from its checkpoint
then rewrites the same maps byte for byte.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.models  # noqa: F401
import launch_torch
from dreammat_tpu.models import exporter as jexp
from dreammat_tpu_torch.models import exporter as texp
from dreammat_tpu_torch.models.diffusion.convert import geometry_params_from_numpy
from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj
from dreammat_tpu_torch.utils import saving
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


GEO_CFG = {"shape_init_params": 0.8, "pos_encoding_config": {
    "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
    "base_resolution": 4, "per_level_scale": 1.5}}
MAT_CFG = {"environment_texture": "/nonexistent", "n_environments": 1, "env_height": 16,
           "env_width": 32}


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    return write_obj(str(tmp_path_factory.mktemp("mesh") / "torus.obj"), *torus_arrays())


@pytest.fixture(scope="module")
def uv(torus):
    geo = dreammat_tpu_torch.find("dreammat-mesh")(dict(GEO_CFG, shape_init=f"mesh:{torus}"),
                                                   device="cpu")
    m = geo.isosurface()
    return m.v_pos.numpy(), m.t_pos_idx.numpy()


def test_smart_unwrap_is_the_jax_unwrap(uv):
    v, f = uv
    tv, tf = texp.smart_unwrap(v, f)
    jv, jf = jexp.smart_unwrap(v, f)
    assert np.array_equal(tv, jv) and np.array_equal(tf, jf)
    assert tv.min() >= 0.0 and tv.max() <= 1.0


def test_rasterize_uv_texels_matches_jax(uv):
    vt, ft = texp.smart_unwrap(*uv)
    got = texp.rasterize_uv_texels(vt, ft, 64, device="cpu")
    ref = jexp.rasterize_uv_texels(vt, ft, 64)
    same = (got["hit"].numpy() == np.asarray(ref["hit"])) & (
        got["face"].numpy() == np.asarray(ref["face"]))
    assert same.mean() >= 0.999
    both = got["hit"].numpy() & np.asarray(ref["hit"]) & same
    for k in ("u", "v"):
        assert np.abs(got[k].numpy()[both] - np.asarray(ref[k])[both]).max() <= 1e-5, k
    assert 0.2 < got["hit"].float().mean() < 0.95


def test_inpaint_padding_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(40, 40, 3).astype(np.float32)
    valid = rng.rand(40, 40) > 0.85
    got = texp.inpaint_padding(torch.from_numpy(img), torch.from_numpy(valid))
    ref = jexp.inpaint_padding(jnp.asarray(img), jnp.asarray(valid))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6


def test_export_maps_and_text_match_jax(torus, tmp_path, monkeypatch):
    find_j, find_t = dreammat_tpu.find, dreammat_tpu_torch.find
    gcfg = dict(GEO_CFG, shape_init=f"mesh:{torus}")
    jgeo, jmat = find_j("dreammat-mesh")(dict(gcfg)), find_j("dreammat-material")(dict(MAT_CFG))
    tgeo = find_t("dreammat-mesh")(dict(gcfg), device="cpu")
    tmat = find_t("dreammat-material")(dict(MAT_CFG), device="cpu")
    params = jgeo.init(jax.random.PRNGKey(1))
    field = tgeo.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))

    captured = {}
    real = jexp.saving.save_obj_with_mtl

    def capture(*a, **k):
        captured.update(k)
        return real(*a, **k)

    monkeypatch.setattr(jexp.saving, "save_obj_with_mtl", capture)
    jexp.MeshExporter({"texture_size": 64}, jgeo, jmat).export_obj_with_mtl(
        params, str(tmp_path / "jax"))
    exporter = texp.MeshExporter({"texture_size": 64}, tgeo, tmat, device="cpu")
    exporter.export_obj_with_mtl(field, str(tmp_path / "torch"))
    for key, name in (("albedo", "albedo_map"), ("metallic", "metallic_map"),
                      ("roughness", "roughness_map")):
        a = exporter.maps[key].astype(int)
        b = np.asarray(captured[name]).astype(int)
        assert a.shape == b.shape, key
        diff = np.abs(a - b)
        assert (diff <= 1).mean() >= 0.999, (key, diff.max())
    for name in ("model.obj", "model.mtl"):
        with open(tmp_path / "jax" / name) as fj, open(tmp_path / "torch" / name) as ft:
            assert fj.read().splitlines() == ft.read().splitlines(), name


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def _smooth_image(h=70, w=93):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 7.0) * np.cos(yy / 9.0)], -1)
    return (img * 255 + 0.5).astype(np.uint8)


def _render_like_frames(n=3, h=64, w=64):
    """A shaded two-tone sphere on white, lit from a turning direction."""
    yy, xx = np.mgrid[0:h, 0:w]
    x, y = (xx - w / 2 + 0.5) / (w * 0.4), (yy - h / 2 + 0.5) / (h * 0.4)
    r2 = x * x + y * y
    z = np.sqrt(np.clip(1 - r2, 0, 1))
    t = (x + 1) / 2
    albedo = np.stack([0.8 * t + 0.2 * (1 - t), 0.3 + 0.2 * t, 0.2 * (1 - t) + 0.6 * t], -1)
    frames = []
    for i in range(n):
        light = np.array([np.cos(i * 0.3), 0.3, 0.8])
        light /= np.linalg.norm(light)
        shade = np.clip(x * light[0] + y * light[1] + z * light[2], 0, 1) * 0.8 + 0.15
        img = np.where((r2 < 1)[..., None], albedo * shade[..., None], 1.0)
        frames.append((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
    return frames


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_to_the_array(channels, tmp_path):
    img = _smooth_image()
    path = str(tmp_path / "sub" / "img.png")
    if channels == 4:
        saving.save_image_with_alpha(path, img, img[..., :1] / 255.0, data_range=(0, 255))
        arr = np.concatenate([img, img[..., :1]], -1)
    else:
        arr = img[..., 0] if channels == 1 else img
        saving.save_image(path, arr)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(np.asarray(Image.open(path)), arr)


def test_gif_frames_decode_close(tmp_path):
    frames = _render_like_frames()
    path = saving.save_gif(str(tmp_path / "turn.gif"), frames, fps=30, data_range=(0, 255))
    gif = Image.open(path)
    assert gif.n_frames == len(frames) and gif.info.get("loop") == 0
    for i, f in enumerate(frames):
        gif.seek(i)
        assert gif.info.get("duration") == 30
        assert np.abs(np.asarray(gif.convert("RGB")).astype(int) - f).mean() <= 3.0


@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_quality_matches_pil(gray, tmp_path):
    """The export's maps are JPEGs under ``.jpg`` names, at quality 75."""
    img = _smooth_image()
    arr = img[..., 1] if gray else img
    mode = "L" if gray else "RGB"
    path = saving.save_image(str(tmp_path / "map.jpg"), arr[..., None] if gray else arr,
                             data_range=(0, 255))
    with open(path, "rb") as f:
        data = f.read()
    assert data[:3] == b"\xff\xd8\xff" and data[-2:] == b"\xff\xd9"
    ours = np.asarray(Image.open(path).convert(mode))
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=75)
    pil = np.asarray(Image.open(buf).convert(mode))
    psnr = lambda x: 10 * np.log10(255.0 ** 2 / np.mean((x.astype(float) - arr) ** 2))
    assert psnr(ours) >= 35.0
    assert abs(psnr(ours) - psnr(pil)) <= 1.0


# ---------------------------------------------------------------------------
# launch_torch.py
# ---------------------------------------------------------------------------

def test_launch_train_then_export_from_checkpoint(torus, tmp_path):
    common = ["--config", "configs/dreammat_tiny.yaml", "--device", "cpu",
              "system.prompt_processor.prompt=a torus", f"system.geometry.shape_init=mesh:{torus}",
              "system.material.use_prefiltered=true", "data.fix_view_num=2",
              "data.hybrid_mc_every=2", "data.n_test_views=1", "data.static_field_maps=false",
              "system.exporter.texture_size=64", "trainer.max_steps=2",
              "checkpoint.every_n_train_steps=2", "trainer.val_check_interval=2",
              "system.save_train_image_iter=1", f"exp_root_dir={tmp_path}",
              "use_timestamp=false"]
    res = launch_torch.main(["--train", *common])
    trial = res["trial_dir"]
    assert res["system"].step_kinds[0] == "mc"  # step 0 is a hybrid MC step
    save = os.path.join(trial, "save")
    for rel in ("it2-test/0.png", "it2-test/albedo/0.png", "it2-test/roughness/0.png",
                "it2-test/metallic/0.png"):
        assert open(os.path.join(save, rel), "rb").read(8) == b"\x89PNG\r\n\x1a\n", rel
    assert open(os.path.join(save, "it2-test.gif"), "rb").read(6) == b"GIF89a"
    for rel in ("it1-train.png", "it2-train.png", "it2-val.png"):  # the fit's hooks
        assert Image.open(os.path.join(save, rel)).size[0] > 0, rel
    assert os.path.exists(os.path.join(trial, "cmd.txt"))
    assert os.path.exists(os.path.join(trial, "parsed.yaml"))
    export = os.path.join(save, "export")
    names = ("texture_kd.jpg", "texture_metallic.jpg", "texture_roughness.jpg", "model.obj",
             "model.mtl")
    first = {n: open(os.path.join(export, n), "rb").read() for n in names}
    for n in names[:3]:
        assert first[n][:3] == b"\xff\xd8\xff" and first[n][-2:] == b"\xff\xd9", n
        Image.open(io.BytesIO(first[n])).load()
    ckpt = os.path.join(trial, "ckpts", "step000002.pt")
    for n in names:
        os.remove(os.path.join(export, n))
    res2 = launch_torch.main(["--export", "--resume", ckpt, *common])
    assert res2["system"].global_step == 2
    for n in names:
        assert open(os.path.join(export, n), "rb").read() == first[n], n
