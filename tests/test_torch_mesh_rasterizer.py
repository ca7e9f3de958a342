"""Port parity: the mesh rasterizer, the PBR material and the solid background.

The same numpy inputs (a bumpy sphere on a deformed DMTet lattice at
resolution 14, the JAX fields carried over by the weight bridge) go through
the JAX package (jitted) and the port on the CPU:

- the hit pass: the port casts the soup with the plain plane-equation
  caster (kernel B's plain version), the JAX package's CPU path with a
  Moeller-Trumbore scan; the hit masks agree on all but 1e-3 of the rays
  of a 48^2 view (they may differ on rays through an edge);
- with the JAX hit slots handed to both sides (the port's ``_cast``
  replaced by the JAX one): ``render_rays`` (opacity, depth,
  ``comp_normal``, ``comp_rgb``, ``comp_rgb_fg``; the normal and position
  of hits), with and without colour, in training and evaluation, within
  1e-5; the gradients of the render into the SDF, the deformation and the
  hash grid within 1e-5 (relative to the largest); the chunked
  ``render_image``. The JAX render runs eagerly here: under ``jit`` XLA
  contracts the cross products and the trilinear weights into FMAs, which
  moves the vertex normals of sliver triangles by up to 4e-5 and can turn a
  near-tie of the opacity's max into a tie whose gradient it splits;
- the soup as kernel B sees it: invalid slots (all-zero triangles at the
  origin, id -1) are never hit, also by rays through the origin, and the
  cull's tiles and sub-tiles that hold only invalid slots meet no ray;
- ``pbr-material`` (with and without the bump, its export) and
  ``solid-color-background`` (learned, tiled to 4 channels) within 1e-5;
- finding 4 of the DMTet port: a ray that misses but passes near the
  surface takes the field's colour at slot 0's plane in both packages;
- a warm mesh step builds no tensor from host data (a host sync on the
  card).
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
from dreammat_tpu_torch.models.diffusion.convert import geometry_params_from_numpy

from test_torch_dreammat_step import _np
from torch_threads import one_thread  # noqa: F401

TINY_GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
             "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5}
TOL = 1e-5


def _close(a, b, tol=TOL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0), (what, np.abs(a - b).max())


def _pair(kind, name, cfg):
    return (dreammat_tpu.find(name)(cfg, *kind[0]),
            dreammat_tpu_torch.find(name)(cfg, *kind[1], device="cpu"))


@pytest.fixture(scope="module")
def rig():
    gcfg = {"radius": 1.0, "isosurface_resolution": 14, "max_crossing_tets": 3000,
            "shape_init": "sphere", "shape_init_params": 0.55, "n_feature_dims": 3,
            "pos_encoding_config": TINY_GRID,
            "mlp_network_config": {"n_neurons": 16, "n_hidden_layers": 1}}
    jg, tg = _pair(((), ()), "tetrahedra-sdf-grid", gcfg)
    jp = _np(jg.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    jp["sdf"] = (jp["sdf"] + 0.02 * rng.normal(size=jp["sdf"].shape)).astype(np.float32)
    jp["deformation"] = rng.normal(size=jp["deformation"].shape).astype(np.float32)
    jp["table"] = rng.normal(0, 0.5, jp["table"].shape).astype(np.float32)
    tf = tg.init(torch.Generator().manual_seed(0))
    tf.load_state_dict(geometry_params_from_numpy(jp), strict=True)
    jm, tm = _pair(((), ()), "no-material", {})
    jb, tb = _pair(((), ()), "solid-color-background", {"color": [0.2, 0.5, 0.9]})
    rcfg = {"radius": 1.0, "sdf_opacity_samples": 16, "face_chunk": 1024, "eval_chunk_rays": 500}
    jr = dreammat_tpu.find("nvdiff-rasterizer")(rcfg, jg, jm, jb)
    tr = dreammat_tpu_torch.find("nvdiff-rasterizer")(rcfg, tg, tm, tb, device="cpu")
    return dict(jg=jg, tg=tg, jp=jax.tree_util.tree_map(jnp.asarray, jp), tf=tf, jr=jr, tr=tr,
                bg=tb.init(torch.Generator()))


def _view(n=48, az=30.0, el=20.0, dist=2.2):
    from dreammat_tpu_torch.data.cameras import CameraSet, camera_rays_and_matrices

    cam = CameraSet(np.float32([el]), np.float32([az]), np.float32([dist]), np.float32([50.0]))
    cd = camera_rays_and_matrices(cam, 0, n, n, device="cpu")
    return cd["rays_o"].reshape(-1, 3).numpy(), cd["rays_d"].reshape(-1, 3).numpy()


def _jax_cast(rig):
    """The port's ``_cast`` replaced by the JAX package's CPU scan."""
    jr = rig["jr"]

    def cast(self, ro, rd, tri, valid):
        hid, hit = jr._cast(jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
                            jnp.asarray(tri.numpy()), jnp.asarray(valid.numpy()))
        return torch.from_numpy(np.array(hid)).long(), torch.from_numpy(np.array(hit))

    return cast


def test_hit_pass_agrees_with_jax_on_all_but_edge_rays(rig):
    ro, rd = _view()
    jm = jax.jit(rig["jg"].isosurface)(rig["jp"])
    _, jhit = rig["jr"]._cast(jnp.asarray(ro), jnp.asarray(rd), jm.tri_verts, jm.valid)
    tm = rig["tg"].isosurface(rig["tf"])
    tid, thit = rig["tr"]._cast(torch.from_numpy(ro), torch.from_numpy(rd),
                                tm.tri_verts.detach(), tm.valid)
    jhit = np.asarray(jhit)
    assert 0.2 < jhit.mean() < 0.8
    assert (thit.numpy() != jhit).sum() <= 1e-3 * len(ro)
    # hit slots are valid triangles, misses read slot 0
    assert tm.valid[tid[thit]].all() and (tid[~thit] == 0).all()


def test_invalid_slots_are_never_hit(rig):
    """Rays through the origin, where every invalid slot lies, from six
    directions and from inside the box: none reports an invalid slot."""
    tm = rig["tg"].isosurface(rig["tf"])
    assert (~tm.valid).sum() > 100
    d = np.float32([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0.6, 0.48, 0.64]])
    ro = torch.from_numpy(-1.5 * d)
    tid, hit = rig["tr"]._cast(ro, torch.from_numpy(d), tm.tri_verts.detach(), tm.valid)
    assert hit.all() and tm.valid[tid].all()
    # from the origin itself the ray leaves through the sphere
    tid, hit = rig["tr"]._cast(torch.zeros(6, 3), torch.from_numpy(d), tm.tri_verts.detach(),
                               tm.valid)
    assert hit.all() and tm.valid[tid].all()


@pytest.mark.parametrize("tile", [256, 32])
def test_tiles_of_invalid_slots_meet_no_ray(rig, tile):
    """Kernel B's cull tests no tile (or sub-tile) that holds only invalid
    slots: its box is lo = hi = +inf, which the kernel's slab test (``meets``
    in ray_cast.cu, here in plain fp32 with its 1e-4 padding) meets with no
    ray, also none through the origin where the invalid slots lie; a tile
    with a live slot keeps its finite box."""
    from dreammat_tpu_torch.ops import bvh as tbvh

    tm = rig["tg"].isosurface(rig["tf"])
    soup = rig["tr"].soup_bvh(tm.tri_verts.detach(), tm.valid)
    _, tid = tbvh._plane_tri_data(soup)
    boxes = tbvh._tile_boxes(soup, tid, tile)
    lo, hi = boxes[:, :3], boxes[:, 4:7]
    live = torch.cat([tid >= 0, torch.zeros((-tid.shape[0]) % tile, dtype=torch.bool)])
    live = live.reshape(-1, tile).any(1)
    assert int((~live).sum()) >= 2 and int(live.sum()) >= 2
    assert torch.equal(lo[~live], torch.full_like(lo[~live], float("inf")))
    assert torch.equal(hi[~live], lo[~live])
    assert bool(torch.isfinite(boxes[live]).all())
    ro, rd = (torch.from_numpy(x) for x in _view())
    d0 = torch.nn.functional.normalize(torch.randn(512, 3, generator=torch.Generator()
                                                   .manual_seed(0)), dim=-1)
    axes = torch.eye(3).repeat(2, 1) * torch.tensor([1.0, -1.0]).repeat_interleave(3)[:, None]
    d = torch.cat([rd, d0, axes])
    o = torch.cat([ro, -2.0 * d0, -2.0 * axes])
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    s0 = (lo[:, None] - 1e-4) * inv - o * inv                         # [n, R, 3]
    s1 = (hi[:, None] + 1e-4) * inv - o * inv
    t0 = torch.clamp(torch.minimum(s0, s1).amax(-1), min=0.0)
    t1 = torch.clamp(torch.maximum(s0, s1).amin(-1), max=tbvh.MISS_DEPTH)
    meets = t0 <= t1
    assert not bool(meets[~live].any())
    assert bool(meets[live].any())


@pytest.mark.parametrize("render_rgb,is_train", [(True, True), (True, False), (False, True)])
def test_render_rays_matches_jax_with_its_hits(rig, monkeypatch, render_rgb, is_train):
    ro, rd = _view(32)
    light = np.broadcast_to(np.float32([1.0, 2.0, 1.5]), ro.shape).copy()
    jout = rig["jr"].render_rays(rig["jp"], {}, {}, jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.asarray(light), jax.random.PRNGKey(0), step=3,
                                 is_train=is_train, render_rgb=render_rgb)
    monkeypatch.setattr(type(rig["tr"]), "_cast", _jax_cast(rig))
    tout = rig["tr"].render_rays(rig["tf"], rig["bg"], None, torch.from_numpy(ro),
                                 torch.from_numpy(rd), torch.from_numpy(light), None, step=3,
                                 is_train=is_train, render_rgb=render_rgb)
    keys = ["opacity", "depth", "comp_normal", "comp_rgb", "comp_rgb_bg", "hit"] + (
        ["comp_rgb_fg"] if render_rgb else [])
    assert ("comp_rgb_fg" in tout) == ("comp_rgb_fg" in jout) == render_rgb
    for key in keys:
        _close(tout[key].detach(), jout[key], what=key)
    # the raw normal and position of a miss extrapolate slot 0's plane far
    # outside the triangle, which magnifies the rounding: held on hits only
    hit = np.asarray(jout["hit"])
    for key in ("normal", "positions"):
        _close(tout[key].detach()[hit], np.asarray(jout[key])[hit], what=key)
    assert 0 < float(jout["opacity"].min()) < 0.5 < float(jout["opacity"].max())


def test_render_gradients_match_jax_with_its_hits(rig, monkeypatch):
    ro, rd = _view(32, az=-60.0)
    light = np.broadcast_to(np.float32([1.0, 2.0, 1.5]), ro.shape).copy()
    rng = np.random.RandomState(1)
    c = rng.normal(size=(len(ro), 3)).astype(np.float32)
    c2 = rng.normal(size=(len(ro), 1)).astype(np.float32)

    def jloss(gp):
        out = rig["jr"].render_rays(gp, {}, {}, jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(light), jax.random.PRNGKey(0), step=3,
                                    is_train=True)
        return (jnp.sum(out["comp_rgb"] * c) + jnp.sum(out["comp_normal"] * c)
                + jnp.sum(out["opacity"] * c2) + jnp.sum(out["depth"] * c2))

    jgrad = _np(jax.grad(jloss)(rig["jp"]))
    monkeypatch.setattr(type(rig["tr"]), "_cast", _jax_cast(rig))
    tf = rig["tf"]
    tf.zero_grad(set_to_none=True)
    out = rig["tr"].render_rays(tf, rig["bg"], None, torch.from_numpy(ro), torch.from_numpy(rd),
                                torch.from_numpy(light), None, step=3, is_train=True)
    (torch.sum(out["comp_rgb"] * torch.from_numpy(c))
     + torch.sum(out["comp_normal"] * torch.from_numpy(c))
     + torch.sum(out["opacity"] * torch.from_numpy(c2))
     + torch.sum(out["depth"] * torch.from_numpy(c2))).backward()
    ref = geometry_params_from_numpy(jgrad)
    for name, p in tf.named_parameters():
        assert float(ref[name].abs().max()) > 0, name
        _close(p.grad, ref[name], what=name)


def test_render_image_matches_jax_with_its_hits(rig, monkeypatch):
    from dreammat_tpu_torch.data.cameras import camera_rays_and_matrices, make_eval_cameras

    cd = camera_rays_and_matrices(make_eval_cameras(4, 15.0, 2.0, 60.0), 1, 30, 40, device="cpu")
    ro, rd = cd["rays_o"].numpy(), cd["rays_d"].numpy()
    lp = cd["camera_position"].reshape(3).numpy()
    jout = rig["jr"].render_image(rig["jp"], {}, {}, jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.asarray(lp), jax.random.PRNGKey(0), step=3)
    monkeypatch.setattr(type(rig["tr"]), "_cast", _jax_cast(rig))
    tout = rig["tr"].render_image(rig["tf"], rig["bg"], None, torch.from_numpy(ro),
                                  torch.from_numpy(rd), torch.from_numpy(lp), None, step=3)
    assert sorted(tout) == sorted(jout) == ["comp_normal", "comp_rgb", "depth", "opacity"]
    for key in jout:
        _close(tout[key], jout[key], what=key)


def test_near_miss_rays_take_the_field_colour(rig):
    """Finding 4: the composite is rgb_fg op + bg (1 - op) with op = clip(0.5
    sigmoid(50 max sdf) + 0.5 hit), and rgb_fg is the material at the
    position re-interpolated on slot 0 for every ray, so a ray that misses
    but passes near the surface (0 < op < 0.5) takes colour from an
    unrelated point, in both packages. The normal image is masked by the
    hit and has no such colour."""
    ro, rd = _view(40)
    light = np.zeros_like(ro)
    jout = rig["jr"].render_rays(rig["jp"], {}, {}, jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.asarray(light), jax.random.PRNGKey(0), step=3)
    tout = rig["tr"].render_rays(rig["tf"], rig["bg"], None, torch.from_numpy(ro),
                                 torch.from_numpy(rd), torch.from_numpy(light), None, step=3)
    bg = np.float32([0.2, 0.5, 0.9])
    for out in (jout, {k: v.detach().numpy() for k, v in tout.items() if k != "mesh"}):
        hit, op = np.asarray(out["hit"]), np.asarray(out["opacity"])[:, 0]
        rgb = np.asarray(out["comp_rgb"])
        near = ~hit & (op > 0.01)
        assert near.sum() > 20, near.sum()
        leak = np.abs(rgb[near] - bg).max(axis=-1)
        assert (leak > 1e-4).mean() > 0.9
        # the leak is exactly the foreground colour times op; the normal is masked
        fg = (rgb[near] - bg * (1 - op[near, None])) / op[near, None]
        assert ((fg > -1e-4) & (fg < 1 + 1e-4)).all()
        assert (np.asarray(out["comp_normal"])[~hit] == 0).all()


def _material_inputs(n=64, seed=2, dims=8):
    rng = np.random.RandomState(seed)
    f = rng.normal(size=(n, dims)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    tan = np.cross(nrm, rng.normal(size=(n, 3))).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    return f, nrm, vd, tan


@pytest.fixture(scope="module")
def jit_splitsum():
    """``dreammat_tpu.ops.envmap.build_splitsum`` jitted for the module's
    tests (the JAX ``pbr-material`` builds its split-sum stack with it): op
    by op it takes 10 s for a 16 x 32 base on a CPU, jitted under 2 s, and
    the two agree within 4e-7 of the stack's largest value. The JAX
    package's files stay as they are."""
    from dreammat_tpu.ops import envmap

    mp = pytest.MonkeyPatch()
    mp.setattr(envmap, "build_splitsum",
               jax.jit(envmap.build_splitsum, static_argnames=("base_h", "base_w")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pbr(jit_splitsum):
    cfg = {"splitsum_base_res": 16, "environment_texture": "/nonexistent.hdr"}
    return (dreammat_tpu.find("pbr-material")(cfg),
            dreammat_tpu_torch.find("pbr-material")(cfg, device="cpu"))


@pytest.mark.parametrize("bump", [False, True])
def test_pbr_material_matches_jax(pbr, bump):
    jm, tm = pbr
    _close(tm.fg_lut, jm.fg_lut, what="lut")
    for key in ("diffuse", "specular", "levels"):
        _close(tm.splitsum[key], jm.splitsum[key], what=key)
    f, nrm, vd, tan = _material_inputs()
    kw = {"tangent": tan} if bump else {}
    jout = jm(jnp.asarray(f), shading_normal=jnp.asarray(nrm), viewdirs=jnp.asarray(vd),
              **{k: jnp.asarray(v) for k, v in kw.items()})
    tout = tm(torch.from_numpy(f), shading_normal=torch.from_numpy(nrm),
              viewdirs=torch.from_numpy(vd), **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(tout, jout, what="rgb")
    je, te = jm.export(jnp.asarray(f)), tm.export(torch.from_numpy(f))
    assert sorted(te) == sorted(je) == ["albedo", "bump", "metallic", "roughness"]
    for key in je:
        _close(te[key], je[key], what=key)


def test_pbr_material_needs_normal_and_view():
    tm = dreammat_tpu_torch.find("pbr-material")({"splitsum_base_res": 8}, device="cpu")
    with pytest.raises(ValueError, match="viewdirs"):
        tm(torch.zeros(2, 8))


@pytest.mark.parametrize("cfg", [{}, {"learned": True, "color": [0.1, 0.7, 0.3]},
                                 {"n_output_dims": 4, "color": [0.2, 0.4, 0.6]}])
def test_solid_color_background_matches_jax(cfg):
    jb, tb = _pair(((), ()), "solid-color-background", cfg)
    jp = _np(jb.init(jax.random.PRNGKey(0)))
    field = tb.init(torch.Generator())
    field.load_state_dict(geometry_params_from_numpy(jp), strict=True)
    assert (len(list(field.parameters())) == 1) == bool(cfg.get("learned"))
    d = np.random.RandomState(3).normal(size=(5, 7, 3)).astype(np.float32)
    out = tb(torch.from_numpy(d), field)
    _close(out.detach(), jb(jnp.asarray(d), jax.tree_util.tree_map(jnp.asarray, jp)))
    assert out.shape == (5, 7, cfg.get("n_output_dims", 3))


def test_silhouette_samples_the_lattice_cell_centred():
    """Finding 5: the SDF opacity reads the (res+1)^3 vertex lattice through
    ``trilinear_sample``, which is cell-centred (align_corners=False): vertex
    i, at -1 + 2i/res, is read at -1 + (2i+1)/(res+1). So the opacity's
    level set sits at res/(res+1) of the mesh's radius about the centre, in
    both packages; the marching-tets surface is at the radius itself."""
    from dreammat_tpu.models.geometry_volume import trilinear_sample as jtri
    from dreammat_tpu_torch.models.geometry_volume import trilinear_sample as ttri
    from dreammat_tpu_torch.ops import dmtet as tdmtet

    res, r = 16, 0.5
    lat = tdmtet.build_tet_lattice(res)
    v = lat.verts * 2.0 - 1.0
    sdf = (r - np.linalg.norm(v, axis=-1)).astype(np.float32)
    grid = sdf.reshape(res + 1, res + 1, res + 1, 1)
    b = np.linspace(0.40, 0.55, 3001).astype(np.float32)
    pts = np.stack([np.zeros_like(b), b, np.zeros_like(b)], -1)
    x01 = (pts + 1.0) / 2.0
    for s in (ttri(torch.from_numpy(grid), torch.from_numpy(x01))[:, 0].numpy(),
              np.asarray(jtri(jnp.asarray(grid), jnp.asarray(x01)))[:, 0]):
        crossing = b[np.argmax(s <= 0)]
        assert abs(crossing - r * res / (res + 1)) < 1e-3, crossing
    mesh = tdmtet.marching_tets_fixed(torch.from_numpy(sdf), torch.from_numpy(v),
                                      torch.from_numpy(lat.tets).long(), 4096)
    radii = mesh.tri_verts[mesh.valid].norm(dim=-1)
    assert (radii <= r + 1e-6).all() and radii.max() > r - 1e-6


def test_warm_mesh_step_copies_nothing_from_the_host(monkeypatch):
    """After a first call (which puts the tables on the device), the mesh
    part of a training step (the isosurface, the hit pass, the render with
    ``pbr-material`` and the hash grid, ``normal_consistency`` on the
    render's vertex normals, ``laplacian_smoothness``, the backward) builds
    no tensor from host data: on the card each such copy would be a host
    sync (the smoke checks that with ``torch.cuda.set_sync_debug_mode``)."""
    from dreammat_tpu_torch.ops import dmtet as tdmtet

    gcfg = {"radius": 1.0, "isosurface_resolution": 10, "max_crossing_tets": 1500,
            "shape_init": "sphere", "shape_init_params": 0.55, "n_feature_dims": 8,
            "pos_encoding_config": TINY_GRID}
    find = dreammat_tpu_torch.find
    geo = find("tetrahedra-sdf-grid")(gcfg, device="cpu")
    mat = find("pbr-material")({"environment_texture": "/nonexistent.hdr",
                                "splitsum_base_res": 16}, device="cpu")
    ren = find("nvdiff-rasterizer")({"radius": 1.0, "sdf_opacity_samples": 8}, geo, mat,
                                    find("solid-color-background")({}, device="cpu"),
                                    device="cpu")
    field = geo.init(torch.Generator().manual_seed(0))
    ro, rd = (torch.from_numpy(x) for x in _view(16))

    def step():
        out = ren.render_rays(field, None, None, ro, rd, torch.zeros_like(ro), is_train=True)
        loss = out["comp_rgb"].sum() + tdmtet.laplacian_smoothness(*out["mesh"]) \
            + tdmtet.normal_consistency(*out["mesh"], vn=out["vertex_normals"])
        loss.backward()
        return out

    step()
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name,
                            lambda *a, _n=name, _r=real, **k: made.append(_n) or _r(*a, **k))
    out = step()
    monkeypatch.undo()
    assert made == []
    assert bool(out["hit"].any()) and field.sdf.grad is not None
    # the render's vertex normals are the soup's: normal_consistency agrees
    nc = tdmtet.normal_consistency(*out["mesh"])
    assert torch.equal(nc, tdmtet.normal_consistency(*out["mesh"], vn=out["vertex_normals"]))
