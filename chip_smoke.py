"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                 # everything, about three minutes
    python3 chip_smoke.py --kernels-only  # build and check the kernels only

It needs a CUDA card (it exits non-zero without one) and the repository
around it (``dreammat_tpu_torch``). Phases, each of which fails the run on
any error:

1. The card (name and power limit from ``nvidia-smi``) and the versions.
2. Build every CUDA kernel of ``dreammat_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print ptxas's register report.
3. Kernel A (flash-attention forward) against ``attention_plain`` at every
   attention shape of the SD2.1 UNet and ControlNet (B = 3 CFG replicas,
   bf16): max and mean error of O, max error of the log-sum-exp, the
   kernel's time, the plain version's, the bound, and
   ``torch.nn.functional.scaled_dot_product_attention``'s as a yardstick.
4. Kernel B (dense ray caster) against ``cast_rays_plain`` on one 512^2
   G-buffer view and one visibility-bake batch of the level-6 icosphere.
5. The main path: DreamMat material generation (``configs/dreammat.yaml``,
   tables regime, SD2.1 width, random weights) through the user's entry
   points: system, datamodule setup (prerender), ``fit`` for a few steps.
   Both launch counters are zeroed just before and read just after; each
   must be above 0. The loss must be finite, the field must move, and one
   view re-rendered on the CPU must agree with the card's render.
6. A ``{"kernels": [...]}`` line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Longer logs go to ``outputs/chip_smoke/`` (``--out``). fp32 comparisons run with
TF32 off (``allow_tf32 = False`` for matmuls and cuDNN).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per ray-triangle pair of the plane/edge test: six
# 3-term dots (5 each) + 3 adds of the constants, the divide, two FMAs
# for u and v, and the seven compares and selects of the running minimum
CAST_OPS_PER_PAIR = 35

# (N, M, H) of every D=64 attention in the SD2.1 UNet and ControlNet at a
# 64^2 latent: self-attention at 64^2, 32^2, 16^2 tokens and the 8^2 mid
# block, and cross-attention to the 77 text tokens at each of them
ATTN_SHAPES = [
    (4096, 4096, 5), (1024, 1024, 10), (256, 256, 20), (64, 64, 20),
    (4096, 77, 5), (1024, 77, 10), (256, 77, 20), (64, 77, 20),
]
ATTN_B, ATTN_D = 3, 64


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build(out_dir: str) -> None:
    from dreammat_tpu_torch.ops import kernels

    t0 = time.time()
    seconds = kernels.build()
    log(f"build: {', '.join(f'{k} {v:.1f}s' for k, v in seconds.items())} "
        f"(wall {time.time() - t0:.1f}s, parallel nvcc)")
    for name in kernels.SOURCES:
        text = kernels.build_log(name)
        with open(os.path.join(out_dir, f"ptxas_{name}.log"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_attention(gen: torch.Generator) -> dict:
    import torch.nn.functional as F

    from dreammat_tpu_torch.ops import attention as attn

    B, D = ATTN_B, ATTN_D
    rows = []
    for N, M, H in ATTN_SHAPES:
        q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (N, M, M))
        out, lse = attn.flash_attention_fwd(q, k, v)
        ref, ref_lse = attn._plain_with_lse(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lse_err = (lse - ref_lse).abs().max().item()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not (max_err <= 2e-2 and mean_err <= 2e-3 and lse_err <= 1e-3):
            raise AssertionError(f"attention N={N} M={M} H={H}: max {max_err:.3e} "
                                 f"mean {mean_err:.3e} lse {lse_err:.3e}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 50 if N * M < 1 << 22 else 20
        ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v), iters)
        plain_ms = cuda_ms(lambda: attn._plain_with_lse(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        flops = 4.0 * B * H * N * M * D
        nbytes = 2.0 * B * H * D * (2 * N + 2 * M) + 4.0 * B * H * N
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        rows.append(dict(N=N, M=M, H=H, max_err=max_err, mean_err=mean_err, lse_err=lse_err,
                         ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bound_ms, by=by))
        log(f"attention B={B} N={N:5d} M={M:5d} H={H:2d}: max|err| {max_err:.3e} "
            f"mean {mean_err:.3e} lse {lse_err:.3e} | kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, out, lse, ref, ref_lse, err
    return {"rows": rows}


def phase_ray_cast(gen: torch.Generator) -> dict:
    from dreammat_tpu_torch.data.cameras import make_fixed_cameras
    from dreammat_tpu_torch.models.mesh import make_icosphere
    from dreammat_tpu_torch.models.renderer import _views_rays
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.ops import visibility as vis_lib

    mesh = make_icosphere(6, device="cuda")
    bvh = bvh_lib.build_bvh(mesh.v_pos.cpu().numpy(), mesh.t_pos_idx.cpu().numpy(), device="cuda")
    tri = bvh_lib._plane_tri_data(bvh)
    T = tri[0].shape[1]
    cam = make_fixed_cameras(4, seed=0)
    f32 = lambda x: torch.as_tensor(np.asarray(x[:1], np.float32), device="cuda")
    _, _, ro, rd = _views_rays(f32(cam.elevation_deg), f32(cam.azimuth_deg),
                               f32(cam.camera_distances), f32(cam.fovy_deg), 512, 512)
    dirs = vis_lib._grid_dirs(16, "cuda")
    n_pts = (1 << 16) * 64 // dirs.shape[0]  # bake_vertex_visibility's point chunk
    vp, vn = mesh.v_pos[:n_pts], mesh.v_nrm[:n_pts]
    bake_o = ((vp + vn * 1e-3)[:, None] + dirs[None] * 1e-3).reshape(-1, 3)
    bake_d = dirs[None].expand(n_pts, -1, 3).reshape(-1, 3).contiguous()
    cases = {
        "gbuffer view 512^2": (ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()),
        f"visibility bake batch {n_pts}x256": (bake_o.contiguous(), bake_d),
    }
    rows = []
    for label, (o, d) in cases.items():
        R = o.shape[0]
        # the pairs the kernel's tile cull keeps, counted by the kernel
        pairs_t = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri, pairs_out=pairs_t)
        ref = bvh_lib.cast_rays_plain(bvh, o, d, chunk=2048, tri_data=tri)
        torch.cuda.synchronize()
        flips = int((got["hit"] != ref["hit"]).sum())
        both = got["hit"] & ref["hit"]
        t_err = (got["t"][both] - ref["t"][both]).abs().max().item() if bool(both.any()) else 0.0
        if flips > max(1, int(1e-5 * R)) or t_err > 1e-4:
            raise AssertionError(f"ray cast {label}: {flips} hit flips, max |dt| {t_err:.3e}")
        ms = cuda_ms(lambda: bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri), 3)
        plain_ms = cuda_ms(lambda: bvh_lib.cast_rays_plain(bvh, o, d, chunk=2048, tri_data=tri), 1,
                           warmup=0)
        pairs = float(pairs_t.item())
        t_ops = pairs * CAST_OPS_PER_PAIR / PEAK_FP32_FLOPS
        t_bytes = (R * (24 + 16) + T * 13 * 4) / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        # the same bound over every pair, independent of the cull
        all_ms = max(float(R) * T * CAST_OPS_PER_PAIR / PEAK_FP32_FLOPS, t_bytes) * 1e3
        rows.append(dict(label=label, R=R, T=T, pairs=pairs, flips=flips, t_err=t_err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, by=by, bound_all_pairs_ms=all_ms,
                         hit_frac=float(got["hit"].float().mean())))
        log(f"ray cast {label}: R={R} T={T} hits {rows[-1]['hit_frac']:.3f}, flips {flips}, "
            f"max|dt| {t_err:.3e} | pairs the kernel tested {pairs:.4g} "
            f"({100.0 * pairs / (float(R) * T):.1f}% of R x T) | kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}; over all R x T pairs "
            f"{all_ms:.3f} ms), {pairs / ms / 1e6:.1f} Gpairs/s")
        del got, ref
    return {"rows": rows}


def main_config(views: int):
    """``configs/dreammat.yaml`` as the smoke run drives it: random weights,
    the level-6 icosphere, procedural skies, ``views`` fixed cameras, no
    caches."""
    from dreammat_tpu_torch.utils.config import load_config

    return load_config("configs/dreammat.yaml", [
        "system.prompt_processor.prompt=a ceramic vase",
        "system.prompt_processor.use_cache=false",
        "system.geometry.shape_init=procedural:sphere",
        "system.geometry.shape_init_params=6",
        "system.guidance.cache_dir=null",
        "system.guidance.controlnet_path=null",
        "system.material.environment_texture=/nonexistent",
        f"data.fix_view_num={views}",
        "data.prerender_cache_dir=null",
    ])


def phase_main(steps: int, views: int, out_dir: str) -> dict:
    import csv

    import dreammat_tpu_torch
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    cfg = main_config(views)
    find = dreammat_tpu_torch.find
    torch.cuda.reset_peak_memory_stats()
    attn.flash_attention_fwd.launches = 0
    bvh_lib.cast_rays_dense.launches = 0
    t0 = time.time()
    system = find(cfg.system_type)(cfg.system, device="cuda")
    torch.cuda.synchronize()
    t_system = time.time() - t0
    launches_configure = bvh_lib.cast_rays_dense.launches
    log(f"main: system configured in {t_system:.2f}s (mesh {system.renderer.mesh.v_pos.shape[0]} "
        f"vertices, {system.renderer.mesh.t_pos_idx.shape[0]} triangles, visibility bake "
        f"{launches_configure} caster launches)")
    t0 = time.time()
    dm = find(cfg.data_type)(cfg.data, system.renderer, system.material, device="cuda")
    dm.setup()
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    sec = dm.data.seconds
    log(f"main: prerender {views} views in {t_setup:.2f}s: G-buffers {sec['gbuffers']:.3f}s, "
        f"mesh bakes {sec['mesh_bakes']:.3f}s, probes+tables {sec['probes_tables']:.3f}s")
    for name in ("lightmaps", "depths", "normals", "table_spec", "table_diff"):
        x = getattr(dm.data, name)
        if not bool(torch.isfinite(x.float()).all()):
            raise AssertionError(f"prerender {name} is not finite")
    want = (views, cfg.data["fix_env_num"], cfg.data.get("cond_height", 256),
            cfg.data.get("cond_width", 256), 18)
    if tuple(dm.data.lightmaps.shape) != want:
        raise AssertionError(f"lightmaps shape {tuple(dm.data.lightmaps.shape)}")

    system.init_state(seed=0)
    field0 = {n: p.detach().clone() for n, p in system.field.named_parameters()}
    t0 = time.time()
    system.fit(dm, max_steps=steps, seed=0, trial_dir=os.path.join(out_dir, "trial"),
               log_every=1)
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    counts = {"flash_attn_fwd": attn.flash_attention_fwd.launches,
              "ray_cast": bvh_lib.cast_rays_dense.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with open(os.path.join(out_dir, "trial", "logs", "metrics.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    moved = max((p.detach() - field0[n]).abs().max().item()
                for n, p in system.field.named_parameters())
    if not moved > 0:
        raise AssertionError("the field did not move")
    step_s = system.step_seconds
    warm = step_s[1:] if len(step_s) > 1 else step_s
    log(f"main: fit {steps} steps in {t_fit:.2f}s, step seconds "
        f"{', '.join(f'{s:.4f}' for s in step_s)}, warm mean {np.mean(warm):.4f}s; "
        f"losses {', '.join(f'{x:.6g}' for x in losses)}; field max |moved| {moved:.3e}; "
        f"peak memory {peak_gb:.2f} GB")
    log(f"main: launches flash_attn_fwd {counts['flash_attn_fwd']}, ray_cast "
        f"{counts['ray_cast']} ({launches_configure} in the visibility bake)")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # one view re-rendered on the CPU from the same field, G-buffer and table
    batch = dm.collate(step=steps)
    with torch.no_grad():
        gpu = system.renderer.shade_view(system.field, batch["gbuffer"], batch["env_id"],
                                         light_table=batch["light_table"],
                                         jitter_pts=batch["gbuffer"].fg_pos)["comp_rgb"]
        cpu_field = type(system.field)(system.field.enc_cfg, system.geometry.mlp_dims)
        cpu_field.load_state_dict({k: v.cpu() for k, v in system.field.state_dict().items()})
        cpu_gb = type(batch["gbuffer"])(*(x.cpu() for x in batch["gbuffer"]))
        bbox, fg_lut = system.geometry.bbox, system.material.fg_lut
        system.geometry.bbox, system.material.fg_lut = bbox.cpu(), fg_lut.cpu()
        try:
            cpu = system.renderer.shade_view(cpu_field, cpu_gb, batch["env_id"],
                                             light_table=batch["light_table"].cpu(),
                                             jitter_pts=cpu_gb.fg_pos)["comp_rgb"]
        finally:
            system.geometry.bbox, system.material.fg_lut = bbox, fg_lut
    rel = ((gpu.cpu() - cpu).norm() / cpu.norm()).item()
    hw = (cfg.data["height"], cfg.data["width"], 3)
    if tuple(gpu.shape) != hw or not bool(torch.isfinite(gpu).all()) or rel > 1e-4:
        raise AssertionError(f"card render vs CPU: shape {tuple(gpu.shape)}, rel L2 {rel:.3e}")
    log(f"main: view {batch['view_id']} rendered on the card vs the CPU: relative L2 {rel:.3e}")
    return {"counts": counts, "warm_step_s": float(np.mean(warm)), "peak_gb": peak_gb,
            "prerender_s": dict(sec), "losses": losses}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the main path")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--out", default="outputs/chip_smoke")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    t_all = time.time()
    phase_build(args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_res = phase_attention(gen)
    cast_res = phase_ray_cast(gen)
    counts = {"flash_attn_fwd": None, "ray_cast": None}
    if not args.kernels_only:
        main_res = phase_main(args.steps, args.views, args.out)
        counts = main_res["counts"]

    a = max(attn_res["rows"], key=lambda r: r["N"] * r["M"])
    b = max(cast_res["rows"], key=lambda r: r["R"])
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "dreammat_tpu/ops/attention.py:42",
         "launches": counts["flash_attn_fwd"],
         "max_abs_err": max(r["max_err"] for r in attn_res["rows"]),
         "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
         "bound_by": a["by"], "library_ms": a["lib_ms"],
         "work": f"B={ATTN_B} N={a['N']} M={a['M']} H={a['H']} D={ATTN_D} bf16"},
        {"name": "ray_cast", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/ray_cast.cu",
         "replaces": "dreammat_tpu/ops/bvh.py:579",
         "launches": counts["ray_cast"],
         "max_abs_err": max(r["t_err"] for r in cast_res["rows"]),
         "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
         "bound_by": b["by"], "library_ms": None,
         "work": f"R={b['R']} rays x T={b['T']} triangles fp32, {b['pairs']:.4g} pairs "
                 f"after the tile cull; bound over all pairs {b['bound_all_pairs_ms']:.4g} ms"},
    ]
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump({"attention": attn_res, "ray_cast": cast_res, "kernels": kernels,
                   "main": None if args.kernels_only else main_res, "card": card}, f, indent=1)
    log(f"total {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
