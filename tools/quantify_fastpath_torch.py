"""Quantify the fast-path approximation chain of the PyTorch/CUDA port.

    python3 tools/quantify_fastpath_torch.py                       # on the card
    python3 tools/quantify_fastpath_torch.py --device cpu --res 16 --mc-samples 16 \\
        --oct 8 --meshes sphere                                    # tiny, on the CPU

The twin of ``tools/quantify_fastpath.py`` on ``dreammat_tpu_torch``. The
default training path stacks three approximations on top of the exact
Monte-Carlo estimator:

    per-vertex octahedral visibility (oct_res bins)
      -> shadowed-radiance cache
        -> K-level GGX split-sum tables (prerender.TABLE_ALPHAS)

Against exact MC shading with per-ray visibility (the material's shadow
rays through the renderer's ``occlusion``: kernel B on the card), for each
mesh x environment x view x oct_res it measures the colour RMSE of the
tables (``rmse_*``), of the MC estimator with the per-vertex table in place
of the trace (``rmse_mc_*``) and with per-pixel tables (``rmse_px_*``), per
(metallic, roughness) combination of ``MR_COMBOS``, and the cosine of the
material-feature gradient of each against the exact one (``grad_cos``,
``grad_cos_mc``, ``grad_cos_px``), beside the cosine between two
training-mode (randomly rotated) exact gradients (``grad_cos_floor``, the
ceiling an approximation can be expected to reach). One JSON line per row,
then a markdown table. Meshes: ``sphere`` (level-3 icosphere), ``slabs``
(two thin parallel slabs), ``torus`` (self-occluding; ``torus_hi`` and
``torus_xhi`` denser) and ``apple`` (the file ``--apple``, the reference's
example mesh, which a checkout does not hold: the run names the missing
path and stops before any work). Entry points run on the card unless
``--device cpu`` (``device="cpu"``) is given, and raise without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MR_COMBOS = [(0.0, 0.3), (0.9, 0.5), (0.5, 0.1), (0.0, 0.9)]
FLOOR_SEEDS = (11, 1011)  # the two training-mode patterns of the gradient floor
APPLE = "load/shapes/objs/apple.obj"


def make_slabs(device="cuda"):
    """Two parallel THIN slabs: vertex-resolution visibility leaks light
    through thin geometry; this is the adversarial case."""
    from dreammat_tpu_torch.models.mesh import Mesh

    def slab(z0, z1, n=8):
        xs = np.linspace(-1, 1, n)
        v, f = [], []
        for z in (z0, z1):
            base = len(v)
            for y in xs:
                for x in xs:
                    v.append([x, y, z])
            for i in range(n - 1):
                for j in range(n - 1):
                    a = base + i * n + j
                    if z == z1:
                        f += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
                    else:
                        f += [[a, a + n, a + 1], [a + 1, a + n, a + n + 1]]
        return np.asarray(v, np.float32), np.asarray(f, np.int64)

    v1, f1 = slab(0.0, 0.04)     # thin slab near z=0
    v2, f2 = slab(0.5, 0.54)     # second slab casting a shadow on the first
    v = np.concatenate([v1, v2])
    f = np.concatenate([f1, f2 + len(v1)])
    return Mesh.from_numpy(v, f, device=device)


def make_torus(R=0.7, r=0.28, nu=48, nv=24, device="cuda"):
    """Self-occluding geometry (the inner tube shadows itself)."""
    from dreammat_tpu_torch.models.mesh import Mesh

    v, f = [], []
    for i in range(nu):
        a = 2 * np.pi * i / nu
        for j in range(nv):
            b = 2 * np.pi * j / nv
            v.append([
                (R + r * np.cos(b)) * np.cos(a),
                (R + r * np.cos(b)) * np.sin(a),
                r * np.sin(b),
            ])
    for i in range(nu):
        for j in range(nv):
            # winding chosen so area-weighted vertex normals point OUTWARD
            # (major x minor tangent order): inward normals put every
            # visibility-bake origin (pt + eps*nrm) inside the closed
            # surface, where all sphere directions hit
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            f += [[a, b, c], [a, c, d]]
    m = Mesh.from_numpy(np.asarray(v, np.float32), np.asarray(f, np.int64), device=device)
    assert_outward_normals(m, "torus")
    return m


def assert_outward_normals(mesh, name, frac=0.5):
    """Benchmark-mesh orientation guard: cast a ray along each vertex
    normal; on a correctly-oriented mesh the majority must escape (the
    torus' inner ring legitimately re-hits the far wall, so the bar is
    0.5, not ~1.0 — an inside-out mesh traps ~100% of them, which
    silently turns every visibility table to zero)."""
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    bvh = bvh_lib.build_bvh(mesh.v_pos.cpu().numpy(), mesh.t_pos_idx.cpu().numpy(),
                            device=mesh.v_pos.device)
    o = mesh.v_pos + mesh.v_nrm * 1e-3
    out = bvh_lib.cast_rays_chunked(bvh, o, mesh.v_nrm)
    escaped = float(1.0 - out["hit"].float().mean())
    assert escaped > frac, (
        f"{name}: only {escaped:.1%} of normal rays escape - normals look "
        f"inward/inverted; visibility bakes would be all-zero")


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.sum(a * b) / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12))


def build_rig(mesh_or_path, n_envs: int, mc_samples: int, subdiv: int = 0, device="cuda"):
    """The geometry, material and renderer (``visibility_mode: raytrace``:
    the material's tracer is the renderer's ``occlusion``) of one mesh, a
    ``Mesh`` or an OBJ/PLY/GLB path (normalised to radius 0.9). The exact
    estimator runs unstreamed (no ``shading_chunk``; the JAX tool's 8 was
    sized for TPU memory): one shading call traces all of its pixels'
    directions in one cast, [P, 2 x mc_samples, 3] a tensor, about 57 MB at
    96^2 and 256 samples."""
    import dreammat_tpu_torch
    import dreammat_tpu_torch.models  # noqa: F401 (registry)
    from dreammat_tpu_torch.utils.hw import resolve_device

    device = resolve_device(device)
    find = dreammat_tpu_torch.find
    geo_cfg = {"pos_encoding_config": {
        "otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2,
        "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.5}}
    if isinstance(mesh_or_path, str):
        geo = find("dreammat-mesh")(dict(geo_cfg, shape_init=f"mesh:{mesh_or_path}",
                                         shape_init_params=0.9), device=device)
    else:
        geo = find("dreammat-mesh")(dict(geo_cfg, shape_init="procedural:sphere"),
                                    device=device)
        geo.mesh = mesh_or_path
    if subdiv:
        # same surface, 4^subdiv denser visibility sampling: the exact-MC
        # ground truth is invariant; only the baked tables gain density
        from dreammat_tpu_torch.models.mesh import subdivide_mesh

        geo.mesh = subdivide_mesh(geo.isosurface(), subdiv)
    mat = find("dreammat-material")({
        "environment_texture": "load/lights/envmap", "environment_scale": 2.0,
        "n_environments": n_envs, "diffuse_sample_num": mc_samples,
        "specular_sample_num": mc_samples, "use_prefiltered": True,
    }, device=device)
    ren = find("raytracing-renderer")({"visibility_mode": "raytrace"}, geo, mat, None,
                                      device=device)
    return geo, mat, ren


def run(mesh_name, mesh_or_path, oct_resolutions, n_envs, res, mc_samples, seed=0,
        grad_pixels=16384, supersample=1, subdiv=0, device="cuda", weights=None):
    """The rows of one mesh (one per environment x view x oct_res, 2 fixed
    views of ``make_fixed_cameras(2, seed)``). ``weights(GP)`` gives the
    gradient weights W [GP,3] of the loss sum(color * W) (uniform from a
    generator seeded 3 by default); the floor's two training-mode patterns
    draw their rotations from generators seeded ``FLOOR_SEEDS``."""
    from dreammat_tpu_torch.data import prerender as pre
    from dreammat_tpu_torch.data.cameras import camera_rays_and_matrices, make_fixed_cameras
    from dreammat_tpu_torch.ops import visibility as vis_lib
    from dreammat_tpu_torch.utils.rng import TorchDraws

    geo, mat, ren = build_rig(mesh_or_path, n_envs, mc_samples, subdiv, device)
    dev = ren.device
    if weights is None:
        weights = lambda GP: TorchDraws(3, dev).uniform("fastpath_w", (GP, 3))
    cam = make_fixed_cameras(2, seed=seed)
    cds = [camera_rays_and_matrices(cam, i, res, res, device=dev) for i in range(2)]
    gbs = [ren.build_gbuffer(cd["rays_o"], cd["rays_d"], cd["w2c"]) for cd in cds]

    rows = []
    for env_id in range(n_envs):
        for vi, gb in enumerate(gbs):
            valid = gb.fg_valid
            P = gb.fg_pos.shape[0]
            full = lambda x, c=1: torch.full((P, c), x, device=dev)
            tri_bary = (gb.fg_tri, gb.fg_bary)

            def exact(m, r, a, vis=None):
                return mat.shade_raytracing(gb.fg_pos, gb.fg_normal, gb.fg_viewdir, env_id,
                                            m, r, a, None, is_train=False, mask=valid,
                                            vis_data=vis)

            def colors(shade, mr):
                """The foreground colours [n,3] of one (metallic, roughness)."""
                with torch.no_grad():
                    return shade(full(mr[0]), full(mr[1]), full(0.6, 3))["color"][valid]

            gt = {mr: colors(exact, mr) for mr in MR_COMBOS}

            def rmses(shade):
                return {mr: float(torch.sqrt(torch.mean(
                    (colors(shade, mr).double() - gt[mr].double()) ** 2))) for mr in MR_COMBOS}

            # gradients on a pixel subset: the cosine needs the direction,
            # not every pixel
            GP = min(grad_pixels, P)
            sl = lambda x: x[:GP]
            W = weights(GP).to(dev)

            def grad(draws=None, is_train=False, vis=None, light_table=None):
                z = torch.zeros(GP, 5, device=dev, requires_grad=True)
                out, _ = mat(sl(gb.fg_pos), z, z, sl(gb.fg_viewdir), sl(gb.fg_normal), env_id,
                             draws, is_train=is_train, mask=sl(valid), vis_data=vis,
                             light_table=light_table)
                return torch.autograd.grad(torch.sum(out["color"] * W), z)[0]

            g_gt = grad()
            # sample-pattern floor: two independent training-mode patterns
            g_a, g_b = (grad(TorchDraws(s, dev), is_train=True) for s in FLOOR_SEEDS)
            floor_cos = _cos(g_a, g_b)

            for oct_res in oct_resolutions:
                baked = vis_lib.bake_vertex_visibility(ren.bvh, ren.mesh.v_pos, ren.mesh.v_nrm,
                                                       oct_res=oct_res, supersample=supersample)
                mat.set_baked_visibility(baked)
                lvis, e_d, fg_lut, _ = pre.mesh_bakes(ren, mat, n_envs)
                _, tabs = pre.render_probes_for_view(
                    ren, mat, gb, n_envs, cds[vi]["camera_position"], lvis=lvis,
                    e_d_vertex=e_d, oct_res=oct_res, fg_lut=fg_lut)
                table = tabs[env_id].float()
                sub_tri_bary = (sl(gb.fg_tri), sl(gb.fg_bary))
                rm = rmses(lambda m, r, a: mat.shade_prefiltered(
                    gb.fg_normal, gb.fg_viewdir, m, r, a, table, vis_data=tri_bary))
                cos = _cos(grad(vis=sub_tri_bary, light_table=table), g_gt)

                # mc_baked: the exact estimator with each direction's
                # visibility from the bilinear per-vertex table (the gate's
                # fallback regime)
                rm_mc = rmses(lambda m, r, a: exact(m, r, a, tri_bary))
                cos_mc = _cos(grad(vis=sub_tri_bary), g_gt)
                mat.set_baked_visibility(None)  # back to the exact tracer

                # mc_pixel: per-pixel tables, only directional binning left
                pix = vis_lib.bake_pixel_visibility(ren.bvh, gb.fg_pos, gb.fg_normal,
                                                    oct_res=oct_res, supersample=supersample)
                rm_px = rmses(lambda m, r, a: exact(m, r, a, pix))
                cos_px = _cos(grad(vis=vis_lib.PixelVisibility(pix.table[:GP], oct_res)), g_gt)

                row = {
                    "mesh": mesh_name, "env": env_id, "view": vi,
                    "oct_res": oct_res, "subdiv": subdiv,
                    "rmse_mean": float(np.mean(list(rm.values()))),
                    "rmse_max": float(np.max(list(rm.values()))),
                    "grad_cos": cos,
                    "grad_cos_floor": floor_cos,
                    "rmse_mc_mean": float(np.mean(list(rm_mc.values()))),
                    "rmse_mc_max": float(np.max(list(rm_mc.values()))),
                    "grad_cos_mc": cos_mc,
                    "rmse_px_mean": float(np.mean(list(rm_px.values()))),
                    "rmse_px_max": float(np.max(list(rm_px.values()))),
                    "grad_cos_px": cos_px,
                    **{f"rmse_m{m}r{r}": v for (m, r), v in rm.items()},
                }
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def mesh_catalog(apple: str = APPLE, device="cuda"):
    """The meshes by name: a ``Mesh`` maker or, for ``apple``, its path."""
    from dreammat_tpu_torch.models.mesh import make_icosphere

    return {
        "sphere": lambda: make_icosphere(3, device=device),
        "slabs": lambda: make_slabs(device=device),
        "torus": lambda: make_torus(device=device),
        # tessellation sweep: the per-vertex tables interpolate across
        # vertices, so fidelity should scale with vertex density
        "torus_hi": lambda: make_torus(nu=96, nv=48, device=device),
        "torus_xhi": lambda: make_torus(nu=192, nv=96, device=device),
        "apple": lambda: apple,
    }


def summary_table(rows) -> str:
    """Markdown: per (mesh, oct_res), averaged over environments and views."""
    lines = ["| mesh | oct_res | RMSE tables | grad cos tables | RMSE mc_baked "
             "| grad cos mc_baked | RMSE mc_pixel | grad cos mc_pixel | grad cos floor |",
             "|---|---|---|---|---|---|---|---|---|"]
    seen = {}
    for r in rows:
        seen.setdefault((r["mesh"], r["oct_res"]), []).append(r)
    keys = ("rmse_mean", "grad_cos", "rmse_mc_mean", "grad_cos_mc", "rmse_px_mean",
            "grad_cos_px", "grad_cos_floor")
    for (mesh, oc), rs in seen.items():
        lines.append(f"| {mesh} | {oc} | "
                     + " | ".join(f"{np.mean([r[k] for r in rs]):.4f}" for k in keys) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--envs", type=int, default=2)
    ap.add_argument("--mc-samples", type=int, default=256)
    ap.add_argument("--oct", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--grad-pixels", type=int, default=16384,
                    help="pixel subset for the gradient cosines")
    ap.add_argument("--meshes", nargs="+", default=["sphere", "slabs", "torus", "apple"])
    ap.add_argument("--apple", default=APPLE, help="the mesh file of the 'apple' entry")
    ap.add_argument("--supersample", type=int, default=1,
                    help="rays per oct bin axis in the visibility bake (fractional bins)")
    ap.add_argument("--subdiv", type=int, default=0,
                    help="midpoint-subdivision levels before baking (4^n denser tables "
                    "on the same surface)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out-json", default=None,
                    help="append every per-(mesh,oct,env) row to this JSONL")
    args = ap.parse_args(argv)

    from dreammat_tpu_torch.utils.hw import resolve_device

    device = resolve_device(args.device)
    catalog = mesh_catalog(args.apple, device)
    unknown = [m for m in args.meshes if m not in catalog]
    if unknown:
        raise SystemExit(f"unknown meshes {unknown}; choose from {sorted(catalog)}")
    if "apple" in args.meshes and not os.path.exists(args.apple):
        raise FileNotFoundError(f"mesh 'apple': no file at {args.apple} (pass --apple PATH, "
                                f"or leave 'apple' out of --meshes)")
    all_rows = []
    for name in args.meshes:
        rows = run(name, catalog[name](), args.oct, args.envs, args.res, args.mc_samples,
                   grad_pixels=args.grad_pixels, supersample=args.supersample,
                   subdiv=args.subdiv, device=device)
        all_rows += rows
        if args.out_json:
            with open(args.out_json, "a") as fh:
                for r in rows:
                    fh.write(json.dumps(r) + "\n")
    print("\n" + summary_table(all_rows))
    return all_rows


if __name__ == "__main__":
    main()
