"""Time the dense ray caster (kernel B) of one tree of the port, for an A/B
of two versions in one call on the card.

    python3 tools/ab_ray_cast.py --label change
    python3 tools/ab_ray_cast.py --root <unpacked older tree> --label parent

``--root`` puts that tree's ``dreammat_tpu_torch`` first on the path, so
its kernel is built from its own sources (into its own ``build/``). The
rays are made the same way for every tree: one 512^2 G-buffer view of the
first fixed camera, and the first visibility-bake batch of the level-6
icosphere (16,384 vertices x 16^2 directions) in two orders, vertex-major
(for each vertex, every direction) and the bake's direction-major Morton
order (``bake_rays`` of this repository's ``ops/visibility.py``). Then the
tree's whole ``bake_vertex_visibility`` (the prerender's configure phase,
in that tree's own ray order). Run the trees in turns (parent, change,
change, parent) and compare within the call. Each case prints one JSON
line: kernel ms (CUDA events over 3 launches), the pairs the kernel tested,
and a digest of its faces and t so that two trees' answers can be compared.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for key in ("face", "t", "u", "v"):
        h.update(out[key].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="tree whose dreammat_tpu_torch is timed")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_ray_cast: no CUDA device", file=sys.stderr)
        return 2
    cs = _load("_ab_chip_smoke", "chip_smoke.py")
    sys.path.insert(0, os.path.abspath(args.root))
    from dreammat_tpu_torch.data.cameras import make_fixed_cameras
    from dreammat_tpu_torch.models.mesh import make_icosphere
    from dreammat_tpu_torch.models.renderer import _views_rays
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.ops import visibility as tree_vis

    if not bvh_lib.__file__.startswith(os.path.abspath(args.root)):
        raise RuntimeError(f"imported {bvh_lib.__file__}, not from {args.root}")
    # this repository's ray order, whatever the tree under test
    order = _load("_ab_visibility", "dreammat_tpu_torch/ops/visibility.py")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()

    mesh = make_icosphere(6, device="cuda")
    bvh = bvh_lib.build_bvh(mesh.v_pos.cpu().numpy(), mesh.t_pos_idx.cpu().numpy(), device="cuda")
    tri = bvh_lib._plane_tri_data(bvh)
    T = tri[0].shape[1]
    cam = make_fixed_cameras(4, seed=0)
    f32 = lambda x: torch.as_tensor(np.asarray(x[:1], np.float32), device="cuda")
    _, _, ro, rd = _views_rays(f32(cam.elevation_deg), f32(cam.azimuth_deg),
                               f32(cam.camera_distances), f32(cam.fovy_deg), 512, 512)
    dirs = order._grid_dirs(16, "cuda")
    n_pts = (1 << 16) * 64 // dirs.shape[0]
    vp, vn = mesh.v_pos[:n_pts], mesh.v_nrm[:n_pts]
    vm_o = ((vp + vn * 1e-3)[:, None] + dirs[None] * 1e-3).reshape(-1, 3)
    vm_d = dirs[None].expand(n_pts, -1, 3).reshape(-1, 3)
    dm_o, dm_d, _ = order.bake_rays(vp, vn, dirs, 1e-3)
    cases = [("gbuffer view 512^2", ro.reshape(-1, 3), rd.reshape(-1, 3)),
             ("bake batch, vertex-major", vm_o, vm_d),
             ("bake batch, direction-major Morton", dm_o, dm_d)]
    for label, o, d in cases:
        o, d = o.contiguous(), d.contiguous()
        pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
        out = bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri, pairs_out=pairs)
        ms = cs.cuda_ms(lambda: bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri), 3)
        R = o.shape[0]
        print(json.dumps(dict(label=args.label, case=label, R=R, T=T, ms=ms,
                              pairs=int(pairs.item()), pair_frac=int(pairs.item()) / (R * T),
                              gpairs_per_s=R * T / ms / 1e6, digest=_digest(out), card=card)),
              flush=True)

    bake = lambda: tree_vis.bake_vertex_visibility(bvh, mesh.v_pos, mesh.v_nrm, oct_res=16)
    table = bake()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        bake()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    print(json.dumps(dict(label=args.label, case="bake_vertex_visibility level 6", s=seconds,
                          digest=hashlib.sha256(table.table.cpu().numpy().tobytes()).hexdigest()[:16],
                          card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
