"""Time the BVH walk (kernel E) of one tree of the port, for an A/B of two
versions in one call on the card.

    python3 tools/ab_bvh_traverse.py --label change
    python3 tools/ab_bvh_traverse.py --root <unpacked older tree> --label parent

``--root`` puts that tree's ``dreammat_tpu_torch`` first on the path, so
its kernel is built from its own sources (into its own ``build/``). The
rays are made the same way in every tree, at the shapes of ``chip_smoke.py``
main path 13 on its torus (``torus_grid_arrays(nu=2048, nv=1280)``,
5,242,880 triangles): a 512^2 view of the first fixed camera, the first
vertex-bake chunk (16,384 vertices x 16^2 directions, ``bake_rays``'
order), the gate's shadow rays (the view's hit pixels, each with the
material's diffuse and specular directions at roughness 0.3, pixel-major)
and the 2048^2 texel bake of its (u, v) layout; and at the view and bake
chunk of the level-6 icosphere of the kernel phase. Each case prints one
JSON line: the entry (``closest``; ``any_hit`` where the tree has that
entry, on the bake chunk and the shadow rays), event ms (CUDA events over
3 launches after a warm-up), nodes and pairs a ray, and a digest of t,
face, u, v and hit (of hit alone for ``any_hit``), which must be equal
between trees, an any-hit digest equal to the closest-hit digest of hit.
``sorted`` cases time the shadow rays sorted by a key of quantised
direction then origin Morton code, walked and scattered back, all three
inside the events, with the digest of the scattered answer. Run the trees
in turns (parent, change, change, parent) and compare within the call.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch
import yaml

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG_TORUS = (2048, 1280)


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for key in ("t", "face", "u", "v", "hit"):
        if key in out:
            h.update(out[key].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _hit_digest(hit: torch.Tensor) -> str:
    return hashlib.sha256(hit.cpu().numpy().tobytes()).hexdigest()[:16]


def cuda_ms(fn, iters: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """The 10 low bits of int32 ``x`` spread to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def sort_key(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """int32 [R]: the direction's octahedral cell (16 x 16) in the top 8
    bits above the 23 high bits of the origin's 30-bit Morton code (10 bits
    an axis in the rays' box)."""
    n = d / d.abs().sum(-1, keepdim=True)
    flip = (1 - n[:, [1, 0]].abs()) * torch.where(n[:, :2] >= 0, 1.0, -1.0)
    uv = torch.where(n[:, 2:3] >= 0, n[:, :2], flip) * 0.5 + 0.5
    cell = (uv * 16).to(torch.int32).clamp(0, 15)
    lo, hi = o.amin(0), o.amax(0)
    q = ((o - lo) / (hi - lo).clamp(min=1e-12) * 1023).to(torch.int32)
    code = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
    return ((cell[:, 0] * 16 + cell[:, 1]) << 23) | (code >> 7)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="tree whose dreammat_tpu_torch is timed")
    ap.add_argument("--label", required=True)
    ap.add_argument("--cases", default="icosphere,torus", help="icosphere, torus or both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_bvh_traverse: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import dreammat_tpu_torch
    from dreammat_tpu_torch.data.cameras import make_fixed_cameras
    from dreammat_tpu_torch.models import exporter as exporter_lib
    from dreammat_tpu_torch.models import mesh as mesh_lib
    from dreammat_tpu_torch.models.renderer import _views_rays
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.ops import visibility as vis_lib
    from dreammat_tpu_torch.utils import ops as uops

    if not bvh_lib.__file__.startswith(os.path.abspath(args.root)):
        raise RuntimeError(f"imported {bvh_lib.__file__}, not from {args.root}")
    has_any = "any_hit" in inspect.signature(bvh_lib.cast_rays_bvh).parameters
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = "cuda"

    def view_and_bake(mesh):
        cam = make_fixed_cameras(4, seed=0)
        f32 = lambda x: torch.as_tensor(np.asarray(x[:1], np.float32), device=dev)
        _, _, ro, rd = _views_rays(f32(cam.elevation_deg), f32(cam.azimuth_deg),
                                   f32(cam.camera_distances), f32(cam.fovy_deg), 512, 512)
        dirs = vis_lib._grid_dirs(16, dev)
        n_pts = (1 << 16) * 64 // dirs.shape[0]
        bo, bd, _ = vis_lib.bake_rays(mesh.v_pos[:n_pts], mesh.v_nrm[:n_pts], dirs, 1e-3)
        return ro.reshape(-1, 3), rd.reshape(-1, 3), bo, bd

    def run(mesh_label, label, bvh, o, d, any_hit_too):
        o, d = o.float().contiguous(), d.float().contiguous()
        packed = bvh_lib.pack_bvh(bvh)
        R = o.shape[0]
        entries = [False] + ([True] if any_hit_too and has_any else [])
        closest_hit = None
        for any_hit in entries:
            kw = {"any_hit": True} if any_hit else {}
            ctr = torch.zeros(2, dtype=torch.int64, device=dev)
            out = bvh_lib.cast_rays_bvh(bvh, o, d, packed=packed, counters_out=ctr, **kw)
            ms = cuda_ms(lambda: bvh_lib.cast_rays_bvh(bvh, o, d, packed=packed, **kw))
            nodes, pairs = ctr.tolist()
            row = dict(label=args.label, mesh=mesh_label, case=label,
                       entry="any_hit" if any_hit else "closest", R=R, ms=ms,
                       nodes_per_ray=nodes / R, pairs_per_ray=pairs / R,
                       hit_frac=float(out["hit"].float().mean()),
                       digest=_hit_digest(out["hit"]) if any_hit else _digest(out),
                       card=card)
            if any_hit:
                row["equals_closest_hit"] = bool(torch.equal(out["hit"], closest_hit))
            else:
                closest_hit = out["hit"]
                row["hit_digest"] = _hit_digest(out["hit"])
            print(json.dumps(row), flush=True)
        return closest_hit

    def sorted_run(mesh_label, label, bvh, o, d, ref_hit):
        """Sort, walk and scatter back, timed together; the tree's hit-mask
        entry (any-hit where it has one)."""
        o, d = o.float().contiguous(), d.float().contiguous()
        packed = bvh_lib.pack_bvh(bvh)
        kw = {"any_hit": True} if has_any else {}

        def go():
            perm = torch.argsort(sort_key(o, d))
            hit = bvh_lib.cast_rays_bvh(bvh, o[perm], d[perm], packed=packed, **kw)["hit"]
            out = torch.empty_like(hit)
            out[perm] = hit
            return out

        got = go()
        ms = cuda_ms(go)
        perm = torch.argsort(sort_key(o, d))
        os_, ds = o[perm].contiguous(), d[perm].contiguous()
        walk_ms = cuda_ms(lambda: bvh_lib.cast_rays_bvh(bvh, os_, ds, packed=packed, **kw))
        print(json.dumps(dict(label=args.label, mesh=mesh_label, case=label + ", sorted",
                              entry="any_hit" if has_any else "closest", R=o.shape[0], ms=ms,
                              walk_ms=walk_ms, digest=_hit_digest(got),
                              equals_unsorted=bool(torch.equal(got, ref_hit)), card=card)),
              flush=True)

    if "icosphere" in args.cases:
        mesh = mesh_lib.make_icosphere(6, device=dev)
        bvh = bvh_lib.build_bvh(mesh.v_pos.cpu().numpy(), mesh.t_pos_idx.cpu().numpy(), device=dev)
        ro, rd, bo, bd = view_and_bake(mesh)
        run("icosphere 81920", "view 512^2", bvh, ro, rd, True)
        run("icosphere 81920", "bake chunk", bvh, bo, bd, True)
        del mesh, bvh, ro, rd, bo, bd
    if "torus" in args.cases:
        v, f, vt = mesh_lib.torus_grid_arrays(0.7, 0.28, *BIG_TORUS)
        mesh = mesh_lib.Mesh.from_numpy(v, f, device=dev)
        bvh = bvh_lib.build_bvh(v, f, device=dev)
        label = f"torus {len(f)}"
        ro, rd, bo, bd = (x.contiguous() for x in view_and_bake(mesh))
        run(label, "view 512^2", bvh, ro, rd, False)
        run(label, "bake chunk", bvh, bo, bd, True)
        del bo, bd
        # the gate's shadow rays: the view's hit pixels (interpolated vertex
        # normals), the material's diffuse and specular directions
        out = bvh_lib.cast_rays_bvh(bvh, ro, rd)
        hit = out["hit"]
        o_h, d_h = ro[hit], rd[hit]
        tri = mesh.t_pos_idx[out["face"][hit].long()]
        u, w = out["u"][hit][:, None], out["v"][hit][:, None]
        pos = o_h + out["t"][hit][:, None] * d_h
        nrm = uops.safe_normalize((1 - u - w) * mesh.v_nrm[tri[:, 0]] + u * mesh.v_nrm[tri[:, 1]]
                                  + w * mesh.v_nrm[tri[:, 2]])
        with open(os.path.join(HERE, "configs", "dreammat.yaml")) as fh:
            mat_cfg = yaml.safe_load(fh)["system"]["material"]
        mat_cfg["environment_texture"] = "/nonexistent"  # the procedural skies
        mat = dreammat_tpu_torch.find("dreammat-material")(mat_cfg, device=dev)
        P = pos.shape[0]
        refl = uops.reflect(-d_h, nrm)
        dirs = torch.cat([mat.sample_diffuse_directions(nrm),
                          mat.sample_specular_directions(refl, torch.full((P, 1), 0.3,
                                                                          device=dev))], dim=1)
        S = dirs.shape[1]
        dirs = dirs.reshape(-1, 3)
        pts = pos[:, None].expand(-1, S, 3).reshape(-1, 3)
        so, sd = pts + dirs * 1e-5, dirs
        del pts, dirs, out, o_h, d_h, tri, pos, nrm, refl, ro, rd
        ref_hit = run(label, f"gate shadow rays ({P} px x {S})", bvh, so, sd, True)
        sorted_run(label, f"gate shadow rays ({P} px x {S})", bvh, so, sd, ref_hit)
        del so, sd, ref_hit, bvh
        torch.cuda.empty_cache()
        ubvh, uo, ud = exporter_lib.uv_texel_rays(vt, f, 2048, dev)
        run(label, "texel bake 2048^2", ubvh, uo, ud, False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
