"""Port parity: a user's own environment maps and meshes.

- Radiance HDR: ``write_hdr`` of both packages writes the same bytes, and
  ``read_hdr`` of both reads a flat and a run-length-encoded file to the
  same values, exactly (the RLE file is written by an encoder here).
- On HDR maps written by the test (one smaller and one larger than the
  environment size, so both directions of the resize run), the tiny
  DreamMat config's environments, light tables and probes, and one view
  shaded by the MC estimator agree with the JAX package to relative L2
  1e-4, the tolerance of ``test_torch_prerender.py`` (the port is handed
  the JAX package's baked visibility table, as there).
- Without OpenCV, an ``.exr`` map raises in the port rather than turn
  into a procedural sky.
- glb (u8, u16 and u32 indices; a file of two primitives with interleaved,
  strided vertex data) and PLY (ascii and binary) meshes written here load
  in both packages' readers to equal vertices and faces, and through
  ``load_mesh`` (centring, rotation, scaling, winding) to 1e-6.
"""

import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.data  # noqa: F401
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.models import mesh as jmesh
from dreammat_tpu.ops import envmap as jenv
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.models import mesh as tmesh
from dreammat_tpu_torch.ops import envmap as tenv
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _radiance(h, w, seed):
    """A map with a wide dynamic range and some black texels."""
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(0.0, 2.0, (h, w, 3))).astype(np.float32)
    img[rng.random((h, w)) < 0.05] = 0.0
    return img


def _rle_channel(row: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 127 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, row[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += bytes([j - i]) + row[i:j]
        i = j
    return bytes(out)


def _write_hdr_rle(path, img):
    """New-style run-length RGBE scanlines (the same RGBE bytes as write_hdr)."""
    flat = str(path) + ".flat.hdr"
    tenv.write_hdr(flat, img)
    data = open(flat, "rb").read()
    H, W = img.shape[:2]
    rgbe = np.frombuffer(data[-H * W * 4:], np.uint8).reshape(H, W, 4)
    body = bytearray()
    for y in range(H):
        body += bytes([2, 2, W >> 8, W & 255])
        for c in range(4):
            body += _rle_channel(rgbe[y, :, c].tobytes())
    with open(path, "wb") as f:
        f.write(data[:-H * W * 4] + bytes(body))


@pytest.mark.parametrize("layout", ["flat", "rle"])
def test_hdr_files_match_jax(tmp_path, layout):
    img = _radiance(12, 40, seed=1)
    pt, pj = str(tmp_path / "t.hdr"), str(tmp_path / "j.hdr")
    tenv.write_hdr(pt, img)
    jenv.write_hdr(pj, img)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    if layout == "rle":
        _write_hdr_rle(pt, img)
        assert os.path.getsize(pt) != os.path.getsize(pj)
    got, ref = tenv.read_hdr(pt), jenv.read_hdr(pj)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, jenv.read_hdr(pt))
    # RGBE keeps 8 bits of mantissa
    nz = img.max(-1) > 0
    assert np.all(np.abs(got[nz] - img[nz]) <= img[nz].max(-1, keepdims=True) / 128)


ENV_SIZES = [(24, 48), (64, 128)]  # the tiny config's environments are 32 x 64
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


@pytest.fixture(scope="module")
def hdr_pair(tmp_path_factory):
    env_dir = tmp_path_factory.mktemp("envmap")
    for i, (h, w) in enumerate(ENV_SIZES):
        os.makedirs(env_dir / f"map{i + 1}")
        tenv.write_hdr(str(env_dir / f"map{i + 1}" / f"map{i + 1}.hdr"), _radiance(h, w, seed=i))
    over = OVERRIDES + [f"system.material.environment_texture={env_dir}"]
    jcfg = jload("configs/dreammat_tiny.yaml", over)
    tcfg = tload("configs/dreammat_tiny.yaml", over)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")
    jb = jsys.material.baked_visibility
    tsys.material.set_baked_visibility(BakedVisibility(torch.as_tensor(np.array(jb.table)),
                                                       jb.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    return jsys, jdm, tsys, tdm


def test_environments_match_jax(hdr_pair):
    jsys, _, tsys, _ = hdr_pair
    got, ref = tsys.material.envs.numpy(), np.asarray(jsys.material.envs)
    assert got.shape == ref.shape == (2, 32, 64, 3)
    for e in range(2):
        assert _rel(got[e], ref[e]) < TOL, e
    # the files were used, not the procedural skies
    sky = tenv.make_procedural_envmap(32, 64, seed=0)
    assert _rel(got[0], sky * tsys.material.cfg.environment_scale) > 0.5


def test_light_tables_and_probes_match_jax(hdr_pair):
    _, jdm, _, tdm = hdr_pair
    j, t = jdm.data, tdm.data
    assert _rel(t.lvis.float().numpy(), np.asarray(j.lvis, np.float32)) < TOL
    assert _rel(t.table_diff.numpy(), j.table_diff) < TOL
    assert _rel(t.table_spec.float().numpy(), np.asarray(j.table_spec, np.float32)) < TOL
    assert _rel(t.lightmaps.float().numpy(), np.asarray(j.lightmaps, np.float32)) < TOL


def test_shaded_view_matches_jax(hdr_pair):
    jsys, jdm, tsys, tdm = hdr_pair
    jg, tg = jdm.data.gbuffers[0], tdm.data.gbuffers[0]
    P = tg.fg_pos.shape[0]
    rng = np.random.RandomState(2)
    a = rng.uniform(0.1, 0.9, (P, 3)).astype(np.float32)
    m = rng.uniform(0, 0.9, (P, 1)).astype(np.float32)
    r = rng.uniform(0.05, 0.8, (P, 1)).astype(np.float32)
    # jitted: eager, the JAX shading is some 170 XLA compiles of one op each
    jout = jax.jit(type(jsys.material).shade_raytracing, static_argnums=(0, 9))(
        jsys.material, jg.fg_pos, jg.fg_normal, jg.fg_viewdir, jnp.int32(1), jnp.asarray(m),
        jnp.asarray(r), jnp.asarray(a), jax.random.PRNGKey(0), False, mask=jg.fg_valid,
        vis_data=(jg.fg_tri, jg.fg_bary))
    with torch.no_grad():
        tout = tsys.material.shade_raytracing(
            tg.fg_pos, tg.fg_normal, tg.fg_viewdir, 1, torch.from_numpy(m), torch.from_numpy(r),
            torch.from_numpy(a), None, is_train=False, mask=tg.fg_valid,
            vis_data=(tg.fg_tri, tg.fg_bary))
    valid = tg.fg_valid.numpy()
    assert _rel(tout["color"].numpy()[valid], np.asarray(jout["color"])[valid]) < TOL


def test_exr_without_opencv_raises(tmp_path, monkeypatch):
    os.makedirs(tmp_path / "map1")
    (tmp_path / "map1" / "map1.exr").write_bytes(b"v/1\x01")
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    with pytest.raises(RuntimeError, match="OpenCV"):
        dreammat_tpu_torch.find("dreammat-material")(
            {"environment_texture": str(tmp_path), "n_environments": 1, "env_height": 8,
             "env_width": 16}, device="cpu")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _glb(path, buffers, accessors, primitives):
    """A .glb of one buffer: ``buffers`` is a list of (bytes, byteStride or
    None) buffer views, ``accessors`` and ``primitives`` glTF JSON."""
    binb, views = b"", []
    for data, stride in buffers:
        view = {"buffer": 0, "byteOffset": len(binb), "byteLength": len(data)}
        if stride:
            view["byteStride"] = stride
        views.append(view)
        binb += data + b"\0" * (-len(data) % 4)
    js = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(binb)}],
          "bufferViews": views, "accessors": accessors,
          "meshes": [{"primitives": primitives}]}
    jb = json.dumps(js).encode()
    jb += b" " * (-len(jb) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(jb) + len(binb)))
        f.write(struct.pack("<II", len(jb), 0x4E4F534A) + jb)
        f.write(struct.pack("<II", len(binb), 0x004E4942) + binb)


def _write_glb_simple(path, v, f, comp):
    dt = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32}[comp]
    idx = np.asarray(f).astype(dt).reshape(-1)
    _glb(path, [(np.asarray(v, np.float32).tobytes(), None), (idx.tobytes(), None)],
         [{"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3"},
          {"bufferView": 1, "componentType": comp, "count": idx.size, "type": "SCALAR"}],
         [{"attributes": {"POSITION": 0}, "indices": 1}])


def _write_glb_two_strided(path, v, f):
    """Two primitives (the halves of the faces, each with its own copy of
    the vertices), positions interleaved with normals at a 24-byte stride."""
    n = np.zeros_like(v)
    inter = np.concatenate([v, n], axis=1).astype(np.float32).tobytes()
    half = len(f) // 2
    bufs = [(inter, 24), (np.asarray(f[:half], np.uint16).tobytes(), None),
            (np.asarray(f[half:], np.uint32).tobytes(), None)]
    acc = [{"bufferView": 0, "byteOffset": 0, "componentType": 5126, "count": len(v),
            "type": "VEC3"},
           {"bufferView": 1, "componentType": 5123, "count": half * 3, "type": "SCALAR"},
           {"bufferView": 2, "componentType": 5125, "count": (len(f) - half) * 3,
            "type": "SCALAR"}]
    _glb(path, bufs, acc, [{"attributes": {"POSITION": 0}, "indices": 1},
                           {"attributes": {"POSITION": 0}, "indices": 2}])


def _write_ply(path, v, f, binary):
    head = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
            f"element vertex {len(v)}", "property float x", "property float y",
            "property float z", "property uchar red", f"element face {len(f)}",
            "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode())
        for p in v:
            fh.write(struct.pack("<fffB", *p, 7) if binary
                     else f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 7\n".encode())
        for tri in f:
            fh.write(struct.pack("<Biii", 3, *tri) if binary
                     else f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())


MESH_CASES = ["glb-u8", "glb-u16", "glb-u32", "glb-two-primitives-strided", "ply-ascii",
              "ply-binary"]


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_files_match_jax(tmp_path, case):
    v, f = tmesh.icosphere_arrays(1 if case == "glb-u8" else 2)
    v = (v * np.float32([1.0, 0.7, 1.3]) + np.float32([0.2, -0.1, 0.3])).astype(np.float32)
    ext = case.split("-")[0]
    path = str(tmp_path / f"mesh.{ext}")
    if case == "glb-two-primitives-strided":
        _write_glb_two_strided(path, v, f)
    elif ext == "glb":
        _write_glb_simple(path, v, f, {"u8": 5121, "u16": 5123, "u32": 5125}[case[4:]])
    else:
        _write_ply(path, v, f, binary=case == "ply-binary")
    load_t = {"glb": tmesh.load_glb, "ply": tmesh.load_ply}[ext]
    load_j = {"glb": jmesh.load_glb, "ply": jmesh.load_ply}[ext]
    tv, tf, tvt, _ = load_t(path)
    jv, jf, jvt, _ = load_j(path)
    assert np.array_equal(tv, jv) and np.array_equal(tf, jf) and tvt is None and jvt is None
    if case == "glb-two-primitives-strided":
        assert len(tv) == 2 * len(v) and np.array_equal(tf[len(f) // 2:] - len(v), f[len(f) // 2:])
    else:
        assert np.array_equal(tv, v) and np.array_equal(tf, f)
    tm = tmesh.load_mesh(path, scale=0.9, mesh_up="+y", mesh_front="+z", device="cpu")
    jm = jmesh.load_mesh(path, scale=0.9, mesh_up="+y", mesh_front="+z")
    assert np.array_equal(tm.t_pos_idx.numpy(), np.asarray(jm.t_pos_idx))
    assert np.abs(tm.v_pos.numpy() - np.asarray(jm.v_pos)).max() <= 1e-6
    assert np.abs(tm.v_nrm.numpy() - np.asarray(jm.v_nrm)).max() <= 1e-6
