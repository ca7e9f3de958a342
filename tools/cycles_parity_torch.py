"""Cycles-parity harness of the PyTorch/CUDA port.

    python3 tools/cycles_parity_torch.py --mesh <mesh>.obj                 # on the card
    python3 tools/cycles_parity_torch.py --device cpu --mesh <mesh>.obj \\
        --views 2 --envs 2 --res 32 --cond-res 32 --mc-samples 16           # tiny, on the CPU

The twin of ``tools/cycles_parity.py`` on ``dreammat_tpu_torch``. The
light-aware ControlNet was trained on Blender/Cycles renders of the fixed
rig; the port renders that condition stack itself, so how far its stack
sits from what the ControlNet expects is measured here, per channel group
(depth / normal / six probes):

- per-group foreground residuals (MAE, RMSE, and the per-view RMSE spread)
  between the port's fast-path condition stack (``prerender``: the
  octahedral convolution bakes) and a reference stack, and
- the frozen ControlNet's response delta: both stacks through the same
  ControlNet, the relative L2 of its residual outputs (in fp64 from the
  bf16 net's outputs). Random weights at seeds 0, 1 and 2 (the SD2.1
  architecture in bf16 for a condition of 64^2 or more, its stem factor 8
  keeping attention at (H/8)^2 tokens; the tiny net below that), or a
  trained net from ``--model DIR`` (``DIR/controlnet``, loaded strictly).

Reference stack, in order of preference: ``--reference-cache DIR``, a
Blender PNG cache in the reference's layout for the same cameras; else the
port's exact probe renderer (``render_probes_for_view_exact``: every sample
direction traced, kernel B on the card) round-tripped through that PNG
layout (``write_reference_png_cache`` / ``load_reference_png_cache``),
which isolates the fast path's and the 8-bit quantisation's error.
``--checkpoint DIR`` keeps each exact view and the fast-path stack as npz
and reuses them on a rerun; ``--limit-views K`` measures an evenly strided
K of the ``--views`` rig, keeping the canonical view indices. Runs on the
card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = {
    "depth": (0, 1),
    "normal": (1, 4),
    "probe_m0r0": (4, 7),
    "probe_m0r.5": (7, 10),
    "probe_m0r1": (10, 13),
    "probe_m1r0": (13, 16),
    "probe_m1r.5": (16, 19),
    "probe_m1r1": (19, 22),
}
APPLE = "load/shapes/objs/apple.obj"


def build_rig(mesh_path, n_views, n_envs, res, env_scale, mc_samples, seed=0, device="cuda"):
    """(geometry, material, renderer, cameras) of the fixed rig on one mesh
    file (normalised to radius 0.9; baked visibility, prefiltered tables).
    ``res`` is the caller's render size (unused here)."""
    import dreammat_tpu_torch
    import dreammat_tpu_torch.models  # noqa: F401 (registry)
    from dreammat_tpu_torch.data.cameras import make_fixed_cameras
    from dreammat_tpu_torch.utils.hw import resolve_device

    device = resolve_device(device)
    find = dreammat_tpu_torch.find
    geo = find("dreammat-mesh")({
        "shape_init": f"mesh:{mesh_path}", "shape_init_params": 0.9,
        "pos_encoding_config": {"otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2,
                                "log2_hashmap_size": 8, "base_resolution": 4,
                                "per_level_scale": 1.5}}, device=device)
    mat = find("dreammat-material")({
        "environment_texture": "load/lights/envmap", "environment_scale": env_scale,
        "n_environments": n_envs, "diffuse_sample_num": mc_samples,
        "specular_sample_num": mc_samples, "use_prefiltered": True}, device=device)
    ren = find("raytracing-renderer")({}, geo, mat, None, device=device)
    return geo, mat, ren, make_fixed_cameras(n_views, seed=seed)


def _raw_depth(gb, cam_pos, res: int) -> np.ndarray:
    """Scene-unit distance from the camera of each foreground pixel [res,res]
    (0 = miss), the depth the PNG cache stores."""
    t = torch.linalg.norm(gb.fg_pos - cam_pos.reshape(1, 3), dim=-1)
    img = torch.zeros(res * res, device=t.device)
    img[gb.fg_idx[gb.fg_valid]] = t[gb.fg_valid]
    return img.reshape(res, res).cpu().numpy()


def our_stack(ren, mat, cam, n_envs, res, cond_res):
    """Fast-path condition stack [Nv, E, cond, cond, 22] float32 (depth,
    normal, six probes) and the raw depth [Nv, res, res]."""
    from dreammat_tpu_torch.data import prerender as pre
    from dreammat_tpu_torch.utils import ops as uops

    data = pre.prerender(ren, mat, cam, res, res, n_envs, cache_dir=None,
                         cond_height=cond_res, cond_width=cond_res)
    Nv = len(cam)
    depths = data.depths.float()[:, None].expand(Nv, n_envs, cond_res, cond_res, 1)
    normals = data.normals.float()[:, None].expand(Nv, n_envs, cond_res, cond_res, 3)
    stacks = torch.cat([depths, normals, data.lightmaps.float()], dim=-1).cpu().numpy()
    cam_pos = uops.camera_position_from_spherical(
        torch.as_tensor(cam.elevation_deg), torch.as_tensor(cam.azimuth_deg),
        torch.as_tensor(cam.camera_distances)).to(ren.device)
    raw = np.stack([_raw_depth(gb, cam_pos[i], res) for i, gb in enumerate(data.gbuffers)])
    return data, stacks, raw


def mc_reference_stack(ren, mat, cam, n_envs, res, cond_res, tmp_dir, checkpoint_dir=None,
                       view_ids=None):
    """The exact probe stack (per-ray visibility), round-tripped through the
    reference's PNG cache layout: [Nv, E, cond, cond, 22] float32.
    ``checkpoint_dir`` keeps each finished view as an npz, reused on a
    rerun; ``view_ids`` are the canonical indices of the views of ``cam``
    (a strided subset of a larger rig), which key those files."""
    from dreammat_tpu_torch.data import prerender as pre
    from dreammat_tpu_torch.data.cameras import camera_rays_and_matrices

    Nv = len(cam)
    lightmaps = np.zeros((Nv, n_envs, res, res, 18), np.float32)
    raw_depth = np.zeros((Nv, res, res), np.float32)
    normals = np.zeros((Nv, res, res, 3), np.float32)
    t_start = time.time()
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    if view_ids is None:
        view_ids = list(range(Nv))
    for i in range(Nv):
        gi = int(view_ids[i])
        ck = (os.path.join(checkpoint_dir, f"mc_view_{gi:03d}_e{n_envs}_r{res}.npz")
              if checkpoint_dir else None)
        if ck and os.path.exists(ck):
            with np.load(ck) as z:
                lightmaps[i], raw_depth[i], normals[i] = z["lm"], z["d"], z["n"]
            print(f"[cycles_parity_torch] exact view {i}/{Nv}: checkpoint hit", flush=True)
            continue
        print(f"[cycles_parity_torch] exact view {i}/{Nv} "
              f"(elapsed {time.time() - t_start:.0f}s)", flush=True)
        cd = camera_rays_and_matrices(cam, i, res, res, device=ren.device)
        gb = ren.build_gbuffer(cd["rays_o"], cd["rays_d"], cd["w2c"])
        lightmaps[i] = pre.render_probes_for_view_exact(ren, mat, gb, n_envs).cpu().numpy()
        normals[i] = gb.cn_normal.float().cpu().numpy()
        raw_depth[i] = _raw_depth(gb, cd["camera_position"], res)
        if ck:
            np.savez_compressed(ck + ".tmp.npz", lm=lightmaps[i], d=raw_depth[i], n=normals[i])
            os.replace(ck + ".tmp.npz", ck)

    pre.write_reference_png_cache(tmp_dir, lightmaps, raw_depth, normals)
    return stack_from_png_cache(tmp_dir, Nv, n_envs, cond_res)


def stack_from_png_cache(dir_path, n_views, n_envs, cond_res) -> np.ndarray:
    """A PNG cache in the reference's layout as a stack [Nv, E, cond, cond, 22]."""
    from dreammat_tpu_torch.data import prerender as pre

    lm, d, n = pre.load_reference_png_cache(dir_path, n_views, n_envs, cond_res, cond_res)
    return np.stack([np.concatenate([d.astype(np.float32), n.astype(np.float32),
                                     lm[:, e].astype(np.float32)], axis=-1)
                     for e in range(n_envs)], axis=1)


def residual_table(ours, ref):
    """Per-group MAE/RMSE over the foreground (ref depth > 1e-3), and the
    per-view RMSE spread (min/max across the measured views)."""
    fg = ref[..., 0] > 1e-3
    rows = {}
    for name, (a, b) in GROUPS.items():
        d = (ours[..., a:b] - ref[..., a:b])[fg]
        view_rmse = []
        for v in range(ours.shape[0]):
            dv = (ours[v, ..., a:b] - ref[v, ..., a:b])[fg[v]]
            if dv.size:
                view_rmse.append(float(np.sqrt((dv ** 2).mean())))
        rows[name] = {
            "mae": float(np.abs(d).mean()),
            "rmse": float(np.sqrt((d ** 2).mean())),
            "rmse_view_min": min(view_rmse) if view_rmse else None,
            "rmse_view_max": max(view_rmse) if view_rmse else None,
        }
    return rows


def controlnet_nets(H: int, model_dir=None, seeds=(0, 1, 2), device="cuda"):
    """(kind, nets, latent side, context width). ``nets`` yields (seed,
    ControlNet) one at a time, each built on ``device`` when it is reached:
    a trained net from ``model_dir/controlnet`` (seed None), else random
    weights (``random_init_``) at each seed, the SD2.1 architecture in bf16
    for H >= 64, the tiny one in fp32 below (a CPU net: kernel A takes bf16
    at head width 64 only)."""
    from dreammat_tpu_torch.models.diffusion import convert
    from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
    from dreammat_tpu_torch.models.diffusion.unet import UNetConfig
    from dreammat_tpu_torch.utils.hw import resolve_device

    device = resolve_device(device)
    real = bool(model_dir) and os.path.isdir(os.path.join(model_dir, "controlnet"))
    if real or H >= 64:
        # stem factor 8 (the full conditioning embedding) keeps the latent at
        # H/8: attention at 4096 tokens for H = 512, not (H/2)^2 = 65,536
        cfg = ControlNetConfig(unet=UNetConfig.sd21(), conditioning_channels=22)
        lat, dtype = H // 8, torch.bfloat16
        kind = "real-sd21" if real else "sd21-random"
    else:
        cfg = ControlNetConfig(unet=UNetConfig.tiny(), conditioning_embedding_channels=(16, 32))
        lat, dtype = H // 2, torch.float32
        kind = "tiny-random"

    def nets():
        for seed in ([None] if real else seeds):
            net = convert.build_on(lambda: ControlNet(cfg), device, dtype).eval()
            if real:
                path = os.path.join(model_dir, "controlnet")
                report = convert.load_model_dir(net, path, "controlnet")
                if report is None or report["missing"] or report["unused"]:
                    raise KeyError(f"{path}: not a strict load of the ControlNet "
                                   f"({'no checkpoint' if report is None else report})")
            else:
                convert.random_init_(net, torch.Generator(device=device).manual_seed(seed))
            yield seed, net.requires_grad_(False)
            del net

    return kind, nets(), lat, cfg.unet.cross_attention_dim


@torch.no_grad()
def response_delta(nets, ours, ref, sample, ctx, t: float = 500.0):
    """Per-seed relative L2 of the ControlNet responses (all down residuals
    and the mid residual, flattened) to the two stacks [Nv, E, H, H, 22]:
    ||r(ours) - r(ref)|| / ||r(ref)||, in fp64 from the net's outputs."""
    per_seed = []
    for seed, net in nets:
        dev = next(net.parameters()).device
        ts = torch.tensor([t], device=dev)

        def respond(stack):
            cond = torch.as_tensor(np.ascontiguousarray(stack), device=dev).permute(2, 0, 1)[None]
            down, mid = net(sample.to(dev), ts, ctx.to(dev), cond, 1.0)
            return torch.cat([x.reshape(-1) for x in list(down) + [mid]]).double()

        deltas = []
        for i in range(ours.shape[0]):
            for e in range(ours.shape[1]):
                ra, rb = respond(ours[i, e]), respond(ref[i, e])
                deltas.append(float(torch.linalg.norm(ra - rb) / (torch.linalg.norm(rb) + 1e-9)))
        per_seed.append({"seed": seed, "rel_l2_mean": float(np.mean(deltas)),
                         "rel_l2_max": float(np.max(deltas))})
    return per_seed


def controlnet_delta(ours, ref, model_dir=None, seeds=(0, 1, 2), device="cuda"):
    """The frozen ControlNet's response delta between the two stacks, at each
    seed's random weights (or the trained net), on one latent sample
    (normal, generator seeded 1) and context [1, 8, ctx] (seeded 2) at
    t = 500. Since one random net's sensitivity is arbitrary, the spread
    over seeds is reported, and the aggregate is the worst seed's."""
    H = ours.shape[2]
    kind, nets, lat, ctx_dim = controlnet_nets(H, model_dir, seeds, device)
    dev = torch.device(device)
    sample = torch.randn(1, 4, lat, lat, generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    ctx = torch.randn(1, 8, ctx_dim, generator=torch.Generator(device=dev).manual_seed(2),
                      device=dev)
    per_seed = response_delta(nets, ours, ref, sample, ctx)
    return {
        "kind": kind,
        "rel_l2_mean": max(r["rel_l2_mean"] for r in per_seed),
        "rel_l2_max": max(r["rel_l2_max"] for r in per_seed),
        "per_seed": per_seed,
    }


def measure(args, env_scale, device) -> dict:
    """One environment scale's row: both stacks, the residual table and the
    ControlNet delta."""
    from dreammat_tpu_torch.data.cameras import CameraSet

    geo, mat, ren, cam = build_rig(args.mesh, args.views, args.envs, args.res, env_scale,
                                   args.mc_samples, device=device)
    view_ids = list(range(args.views))
    kv = args.views
    if args.limit_views and args.limit_views < args.views:
        kv = args.limit_views
        sel = np.unique(np.round(np.linspace(0, args.views - 1, kv)).astype(int))
        view_ids = [int(s) for s in sel]
        cam = CameraSet(cam.elevation_deg[sel], cam.azimuth_deg[sel],
                        cam.camera_distances[sel], cam.fovy_deg[sel])
    ours_ck = (os.path.join(args.checkpoint,
                            f"ours_v{args.views}k{kv}_e{args.envs}_r{args.res}_s{env_scale}.npz")
               if args.checkpoint else None)
    if ours_ck and os.path.exists(ours_ck):
        with np.load(ours_ck) as z:
            ours = z["stacks"]
        print("[cycles_parity_torch] fast-path stack: checkpoint hit", flush=True)
    else:
        _, ours, _ = our_stack(ren, mat, cam, args.envs, args.res, args.cond_res)
        if ours_ck:
            os.makedirs(args.checkpoint, exist_ok=True)
            np.savez_compressed(ours_ck + ".tmp.npz", stacks=ours)
            os.replace(ours_ck + ".tmp.npz", ours_ck)
    if args.reference_cache:
        ref = stack_from_png_cache(args.reference_cache, args.views, args.envs, args.cond_res)
        src = "blender-cache"
    else:
        with tempfile.TemporaryDirectory() as td:
            ref = mc_reference_stack(ren, mat, cam, args.envs, args.res, args.cond_res, td,
                                     checkpoint_dir=args.checkpoint, view_ids=view_ids)
        src = "exact-mc-roundtrip"
    del geo, mat, ren
    return {
        "mesh": os.path.basename(args.mesh), "reference": src,
        "views": args.views, "measured_views": len(view_ids),
        "envs": args.envs, "res": args.res, "mc_samples": args.mc_samples,
        "environment_scale": env_scale, "residuals": residual_table(ours, ref),
        "controlnet_delta": controlnet_delta(ours, ref, args.model, device=device),
    }


def print_table(row) -> None:
    print(f"\n# {row['mesh']} vs {row['reference']} (env_scale={row['environment_scale']})")
    print("| channel group | MAE | RMSE | per-view RMSE min..max |")
    print("|---|---|---|---|")
    for name, r in row["residuals"].items():
        spread = (f"{r['rmse_view_min']:.4f}..{r['rmse_view_max']:.4f}"
                  if r.get("rmse_view_min") is not None else "n/a")
        print(f"| {name} | {r['mae']:.4f} | {r['rmse']:.4f} | {spread} |")
    cn = row["controlnet_delta"]
    print(f"\nControlNet ({cn['kind']}) response rel-L2 (worst seed): "
          f"mean {cn['rel_l2_mean']:.4f}, max {cn['rel_l2_max']:.4f}")
    for r in cn["per_seed"]:
        print(f"  seed {r['seed']}: mean {r['rel_l2_mean']:.4f}, max {r['rel_l2_max']:.4f}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default=APPLE)
    ap.add_argument("--reference-cache", default=None)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--envs", type=int, default=2)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--cond-res", type=int, default=256)
    ap.add_argument("--mc-samples", type=int, default=256)
    ap.add_argument("--environment-scale", type=float, nargs="+", default=[2.0])
    ap.add_argument("--model", default=None, help="dir with controlnet/ weights")
    ap.add_argument("--checkpoint", default=None,
                    help="dir for per-view exact checkpoints and the fast-path stack")
    ap.add_argument("--out-json", default=None, help="also append each row to this JSONL file")
    ap.add_argument("--limit-views", type=int, default=None,
                    help="measure an evenly strided subset of this many views of the "
                    "--views rig (canonical indices kept)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from dreammat_tpu_torch.utils.hw import resolve_device

    device = resolve_device(args.device)
    if not os.path.exists(args.mesh):
        raise FileNotFoundError(f"no mesh at {args.mesh} (pass --mesh PATH)")
    rows = []
    for env_scale in args.environment_scale:
        row = measure(args, env_scale, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out_json:
            with open(args.out_json, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        print_table(row)
    return rows


if __name__ == "__main__":
    main()
