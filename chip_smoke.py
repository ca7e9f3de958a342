"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                 # everything, about five minutes
    python3 chip_smoke.py --kernels-only  # build and check the kernels only

It needs a CUDA card (it exits non-zero without one) and the repository
around it (``dreammat_tpu_torch``, ``launch_torch.py``). Phases, each of
which fails the run on any error:

1. The card (name and power limit from ``nvidia-smi``) and the versions.
2. Build every CUDA kernel of ``dreammat_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together), print ptxas's register report, and check
   in ``cuobjdump -sass`` that kernels A, C and D hold ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA loads) and no ``HMMA`` (mma.sync).
3. Kernel A (flash-attention forward) against ``attention_plain`` at every
   attention shape of the SD2.1 UNet and ControlNet (B = 3 CFG replicas,
   bf16; then B = 2 and B = 4, the batches of the SDS guidance without and
   with Perp-Neg): max and mean error of O, max error of the log-sum-exp, the
   kernel's time (CUDA events over many launches; device time from a
   CUDA-graph replay of 20 launches; host microseconds per launch), the
   plain version's, the bound, and
   ``torch.nn.functional.scaled_dot_product_attention``'s, timed the same
   ways, as a yardstick.
4. Kernels C and D (flash-attention backward, dq and dk/dv) against
   ``attention_backward_plain`` at every attention shape of ControlNet
   training (SD2.1 width, 32^2 latents, the training batch) and at B=3,
   N=M=4096: max and mean error and cosine of dq, dk, dv, each kernel's
   times as above, the plain version's, the bounds, and the autograd
   backward of ``scaled_dot_product_attention`` as a yardstick (its graph
   time is a graph of forward and backward less one of the forward); then autograd through
   ``attention`` against the plain forward and backward.
5. Kernel B (dense ray caster) against ``cast_rays_plain`` on one 512^2
   G-buffer view and one visibility-bake batch of the level-6 icosphere in
   the bake's own ray order (``bake_rays``): hit, t, u, v and face must
   agree bit for bit. The bound counts the pairs the kernel tested (and,
   as a yardstick fixed across versions, all R x T pairs) at
   ``CAST_OPS_PER_PAIR`` rounded fp32 operations each, over the card's
   instruction rate (132 SMs x 128 lanes x ``clocks.max.sm``).
6. Main path 1: DreamMat material generation (``configs/dreammat.yaml``,
   tables regime, SD2.1 width, random weights) through the user's entry
   points: system, datamodule setup (prerender), ``fit`` for a few steps.
   The launch counters are zeroed just before and read just after: kernels
   A and B must have run, and no backward kernel (CSD stop-gradients the
   UNet). The loss must be finite, the field must move, and one view
   re-rendered on the CPU must agree with the card's render.
7. Main path 2: ControlNet training (``configs/controlnet_train.yaml``,
   SD2.1 width, resolution 256, random weights) through
   ``dreammat_tpu_torch.train_controlnet.main`` on a synthetic dataset in
   the native npz layout made from ``--seed`` (one object, 16 views x 5
   environments), for a few steps. Kernels A, C and D must have run exactly
   as often as the ControlNet and the UNet hold attentions (46 forward, 32
   dq, 23 dk/dv per step); the loss must be finite, the ControlNet must move
   and the frozen UNet must not; the diffusers export must load strictly
   into the guidance through ``controlnet_path``.
8. Main path 3: DreamMat on a self-occluding mesh through the command
   line, ``launch_torch.main(["--config", "configs/dreammat.yaml",
   "--train", ...])`` in-process: a torus OBJ (R 0.7, r 0.28, 192 x 96
   quads, 36,864 triangles) written to ``outputs/chip_smoke_launch/``, SD2.1
   width, 512^2, random weights, 4 views, 5 skies, 3 steps with
   ``hybrid_mc_every=2`` (steps 0 and 2 shade through the MC estimator),
   2 test views, the 2048^2 export. The fast-path gate must have run
   (self-occlusion, colour RMSE, grad-cos, decision and seconds printed);
   kernel B must have launched in the gate, in the test views' G-buffers and
   in the texel bake (its launches counted per stage), kernel A 46 times a
   step and no backward kernel; the losses finite and the field moved; the
   test PNGs (and their albedo, roughness and metallic RGBA PNGs), the gif,
   ``model.obj``, ``model.mtl`` and the three JPEG maps present with their
   signatures, and the OBJ's v / vt / vn / f counts those of the mesh and
   its unwrap. Then kernel B against ``cast_rays_plain``, bit for bit, on
   65,536 of the gate's shadow rays (its time on the whole batch) and on a
   256^2 block of the texel bake; and 4096 pixels of view 0 shaded by the MC
   estimator (``is_train=False``) with the baked, the per-pixel and (on 32
   pixels: the CPU's plain caster is slow) the ray-traced visibility, on the
   card and on the CPU, at least 99.9% of pixels within 1e-4; and the 4096
   pixels with ray-traced visibility on the card, kernel B as the tracer
   against the plain caster as the tracer, within 1e-6. Every stage's
   seconds and the table and MC steps' peak memory are printed.
9. Main path 4: DreamMat from a user's own files (``drive_user_files``),
   written under ``outputs/chip_smoke_user/`` and removed after: SD2.1-width
   random weights in the diffusers layout as fp16 safetensors through the
   port's writer (``unet/``, ``vae/`` under the old attention names as 1x1
   convolutions, ``text_encoder/`` with a ``position_ids`` buffer; about 2.6
   GB), five 256 x 512 RGBE maps, the torus of main path 3 as .glb (and as
   .ply, loaded to the same mesh), and a prompt library. Then
   ``launch_torch.main(["--train", ...])`` twice in this process on the .glb
   with a ``lib:`` prompt, Perp-Neg (five replicas per UNet pass),
   Adan, an embedding cache and a prerender cache, 4 views, 2 steps, no
   export (main path 3 covers it). After the first run every tensor of the
   guidance's UNet and VAE and of the prompt processor's CLIP must equal
   the file's (per-tensor checksums) with every key loaded; the second run
   must hit both caches and get the first run's condition maps as the
   cache quantizes them. Then ``generate_controlnet_data_torch.main`` on
   the .glb with the HDR maps (4 views x 5 environments at 256^2), loaded
   through ``ControlNetDataset``: shapes and finite values. Kernel A must
   have run 46 times a step, kernel B in the prerenders and the generator;
   then kernel A against its plain version at the Perp-Neg batch (B = 5,
   N = M = 4096, H = 5; with SDPA's time there) and kernel B bit for bit on
   one 512^2 G-buffer view of the .glb mesh. The seconds of the weight
   loading, both prerenders, each step and the dataset are printed.
10. Main path 5: the rest of DreamMat's options (``drive_options``), on the
   torus of main path 3 written with its (u, v) parameterisation as
   ``vt``, through ``launch_torch.main(["--train", ...])`` twice. Run a:
   random cameras (``data.use_fix_views=false``, ``progressive_until=2``,
   the camera, centre and up perturbs), the UV-space field,
   ``visibility_subdiv=1`` and prompt debiasing (BERT-base, random weights,
   the hash vocabulary), 512^2, 4 steps, 1 test view, the export skipped
   (a UV-space field cannot be exported). Run b: the split-sum path
   (``use_raytracing=false``) on 4 fixed views, 2 steps, 1 test view, no
   export. Per run: finite losses, kernel A 46 times a step and no
   backward kernel, kernel B's launches by stage adding up to its count,
   the test PNG and gif. Run a: kernel B exactly once per step, the
   subdivided mesh's counts those of ``subdivide_mesh`` (V + E, 4F), the
   four debiased prompts in the log; run b: the split-sum stacks of the
   five maps, finite. Then kernel B bit for bit against the plain caster
   on every ray of one more sampled camera (perturbs on) of the
   subdivided torus. The seconds of the random-camera step (beside main
   path 1's fixed-rig step), each step's G-buffer and probe bake, the
   subdivided bake, BERT's build and the debiasing, and ``build_splitsum``
   for the five maps are printed. The same runs go on the CPU at tiny size
   with ``drive_options(work, device="cpu", size="tiny", torus=(24, 12))``.
11. Main path 6: the texcraft family (``drive_texcraft``), on the torus of
   main path 3, through ``launch_torch.main(["--config",
   "configs/texcraft.yaml", "--train", ...])`` three times at SD2.1 width,
   512^2, random weights, 4 fixed views, 1 test view, no export: run
   ``sds`` (the config's SDS guidance, 3 steps), run ``triple``
   (``stable-diffusion-triple-guidance`` with depth, canny, HED and
   NormalBae ControlNets, 2 steps) and run ``perp_neg`` (SDS with
   Perp-Neg, 1 step); then ``playground_2d_torch.main`` at 512^2, 3
   steps. Per run: finite losses, the field moved, the test PNG; kernel A
   exactly 32 launches a step at B = 2, 32 + 4 x 14 = 88 at B = 3 and 32 at
   B = 4 (counted by batch where its wrapper counts a launch), the
   playground 32 a step at B = 3; no backward launch; kernel B in the
   prerender. The triple run's HED (edge map within 1e-3, scribble map on
   99% of its values) and NormalBae (within one 8-bit level, with its
   BatchNorm statistics taken from the render: as the run uses it, with
   random weights and identity statistics, its output depends chaotically
   on rounding, which the card's fp64 forward shows) on a 512^2 render, on
   the card against the same modules on the CPU, with their card times.
   Each run's seconds, warm step and peak memory are printed. The same
   runs go on the CPU at tiny size with ``drive_texcraft(work,
   device="cpu", size="tiny", torus=(24, 12), playground_size=32)``.
12. A ``{"kernels": [...]}`` line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Longer logs go to ``outputs/chip_smoke/`` (``--out``). fp32 comparisons run with
TF32 off (``allow_tf32 = False`` for matmuls and cuDNN).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 lanes of the H100 SXM: 132 SMs x 128; each issues one rounded fp32
# operation per clock (kernel B rounds every operation, so none is an FMA
# and the FMA-doubled 67 TFLOP/s does not apply)
FP32_LANES = 132 * 128
# rounded fp32 operations that every pair kernel B tests executes before
# its pre-division reject (ray_cast.cu; 15 FMUL, FADD and FSETP in the SASS
# of its loop): A = o.N + d0 (3 mul, 3 add), B = d.N (3 mul, 2 add),
# |B| > 1e-12 and A != 0 (2), RN(cut |B|) and the compare with |A| (2).
# Pairs that pass go on to the division, u and v (about 33 more); the
# bound counts the floor that every tested pair needs.
CAST_OPS_PER_PAIR = 15

# (N, M, H) of every D=64 attention in the SD2.1 UNet and ControlNet at a
# 64^2 latent: self-attention at 64^2, 32^2, 16^2 tokens and the 8^2 mid
# block, and cross-attention to the 77 text tokens at each of them
ATTN_SHAPES = [
    (4096, 4096, 5), (1024, 1024, 10), (256, 256, 20), (64, 64, 20),
    (4096, 77, 5), (1024, 77, 10), (256, 77, 20), (64, 77, 20),
]
ATTN_B, ATTN_D = 3, 64

# (N, M, H) of every D=64 attention of ControlNet training at resolution 256
# (32^2 latents): self-attention at 32^2, 16^2, 8^2 tokens and the 4^2 mid
# block, and cross-attention to the 77 text tokens at each
TRAIN_ATTN_SHAPES = [
    (1024, 1024, 5), (256, 256, 10), (64, 64, 20), (16, 16, 20),
    (1024, 77, 5), (256, 77, 10), (64, 77, 20), (16, 77, 20),
]
TRAIN_CONFIG = "configs/controlnet_train.yaml"
# per train step: the ControlNet's 7 and the UNet's 16 transformer blocks hold
# a self- and a cross-attention each; the backward reaches the ControlNet and
# the UNet's 9 up-path blocks (the residuals enter after the down path and
# the mid block), and dk/dv only where k and v carry a gradient (all but the
# UNet's cross-attention, whose k and v come from frozen weights and text)
LAUNCHES_PER_TRAIN_STEP = {"flash_attn_fwd": 46, "flash_attn_bwd_dq": 32,
                           "flash_attn_bwd_dkv": 23}


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


def graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call from a CUDA graph of ``n`` calls,
    replayed ``replays`` times between CUDA events: no host work per launch."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * replays)
    del g
    return ms


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call: a host clock over ``n`` calls issued
    without a synchronize (the launch queue does not fill at these counts)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def sdpa_grad_graph_ms(qt, kt, vt, dot, need) -> float:
    """Device ms of SDPA's autograd backward with respect to the inputs
    flagged in ``need`` (q, k, v): a graph of forward and backward, less a
    graph of the forward alone (autograd's backward runs on the stream of
    its forward, so the two are captured together)."""
    import torch.nn.functional as F

    xs = [x.detach().requires_grad_(n) for x, n in zip((qt, kt, vt), need)]
    wrt = [x for x in xs if x.requires_grad]

    def fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(*xs), wrt, dot)

    with torch.no_grad():
        fwd = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    return graph_ms(fwd_bwd) - fwd


# kernel -> (library, symbol substring) of the kernels that must use wgmma
# (HGMMA) and TMA loads (UTMALDG) and no mma.sync (HMMA)
SM90_KERNELS = {"flash_attn_fwd": ("flash_attn_fwd", "flash_fwd_sm90_kernel"),
                "flash_attn_bwd_dq": ("flash_attn_bwd", "flash_bwd_dq_sm90_kernel"),
                "flash_attn_bwd_dkv": ("flash_attn_bwd", "flash_bwd_dkv_sm90_kernel")}


def check_sass() -> dict:
    from dreammat_tpu_torch.ops import kernels

    found = {}
    for label, (lib, key) in SM90_KERNELS.items():
        ops = kernels.sass_opcodes(kernels.sass(lib))
        fns = [f for f in ops if key in f]
        if len(fns) != 1:
            raise AssertionError(f"{key}: {len(fns)} functions in the SASS of {lib}")
        got = ops[fns[0]]
        if not {"HGMMA", "UTMALDG"} <= got or "HMMA" in got:
            raise AssertionError(f"{key}: SASS opcodes {sorted(got)} lack HGMMA/UTMALDG or "
                                 "hold HMMA")
        found[label] = sorted(o for o in got if o in ("HGMMA", "UTMALDG", "HMMA", "SYNCS"))
        log(f"sass {key}: {', '.join(found[label])} (no HMMA)")
    return found


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def ray_cast_cases(mesh, n_views: int = 4):
    """The two casts of the DreamMat prerender, as (label, origins,
    directions): one 512^2 G-buffer view of the first fixed camera, and the
    first visibility-bake batch (``bake_vertex_visibility``'s point chunk at
    16^2 directions) in the bake's own ray order."""
    from dreammat_tpu_torch.data.cameras import make_fixed_cameras
    from dreammat_tpu_torch.models.renderer import _views_rays
    from dreammat_tpu_torch.ops import visibility as vis_lib

    dev = mesh.v_pos.device
    cam = make_fixed_cameras(n_views, seed=0)
    f32 = lambda x: torch.as_tensor(np.asarray(x[:1], np.float32), device=dev)
    _, _, ro, rd = _views_rays(f32(cam.elevation_deg), f32(cam.azimuth_deg),
                               f32(cam.camera_distances), f32(cam.fovy_deg), 512, 512)
    dirs = vis_lib._grid_dirs(16, dev)
    n_pts = (1 << 16) * 64 // dirs.shape[0]  # bake_vertex_visibility's point chunk
    bake_o, bake_d, _ = vis_lib.bake_rays(mesh.v_pos[:n_pts], mesh.v_nrm[:n_pts], dirs, 1e-3)
    return [("gbuffer view 512^2", ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()),
            (f"visibility bake batch {n_pts}x256", bake_o.contiguous(), bake_d.contiguous())]


def cast_disagreement(got: dict, ref: dict) -> dict:
    """Where two casts differ: hit flips, max |dt| where both hit, and rays
    whose face, u or v differ (kernel B claims 0 of each)."""
    flips = int((got["hit"] != ref["hit"]).sum())
    both = got["hit"] & ref["hit"]
    t_err = (got["t"][both] - ref["t"][both]).abs().max().item() if bool(both.any()) else 0.0
    return {"flips": flips, "t_err": t_err,
            "face_diff": int((got["face"] != ref["face"]).sum()),
            "uv_diff": int(((got["u"] != ref["u"]) | (got["v"] != ref["v"])).sum())}


def cast_bounds(pairs: float, R: int, T: int, clock_hz: float) -> dict:
    """Kernel B's bound over the pairs it tested and over all R x T pairs
    (ms), each the larger of the operations over the fp32 instruction rate
    and the bytes (rays in, hits out, triangles) over the memory rate."""
    rate = FP32_LANES * clock_hz
    t_bytes = (R * (24 + 16) + T * 13 * 4) / PEAK_BYTES
    t_ops = pairs * CAST_OPS_PER_PAIR / rate
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_all_pairs_ms": max(float(R) * T * CAST_OPS_PER_PAIR / rate, t_bytes) * 1e3}


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


def phase_attention(gen: torch.Generator, B: int = ATTN_B) -> dict:
    import torch.nn.functional as F

    from dreammat_tpu_torch.ops import attention as attn

    D = ATTN_D
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
        kern = lambda: attn.flash_attention_fwd(q, k, v)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        ms = cuda_ms(kern, iters)
        plain_ms = cuda_ms(lambda: attn._plain_with_lse(q, k, v), 3)
        lib_ms = cuda_ms(sdpa, iters)
        g_ms, lib_g_ms = graph_ms(kern), graph_ms(sdpa)
        h_us, lib_h_us = host_us(kern), host_us(sdpa)
        flops = 4.0 * B * H * N * M * D
        nbytes = 2.0 * B * H * D * (2 * N + 2 * M) + 4.0 * B * H * N
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        rows.append(dict(B=B, N=N, M=M, H=H, max_err=max_err, mean_err=mean_err, lse_err=lse_err,
                         ms=ms, graph_ms=g_ms, host_us=h_us, plain_ms=plain_ms, lib_ms=lib_ms,
                         lib_graph_ms=lib_g_ms, lib_host_us=lib_h_us, bound_ms=bound_ms, by=by))
        log(f"attention B={B} N={N:5d} M={M:5d} H={H:2d}: max|err| {max_err:.3e} "
            f"mean {mean_err:.3e} lse {lse_err:.3e} | kernel {ms:.4f} ms (graph {g_ms:.4f}, "
            f"host {h_us:.1f} us), sdpa {lib_ms:.4f} ms (graph {lib_g_ms:.4f}, host "
            f"{lib_h_us:.1f} us), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
            f"{flops / g_ms / 1e9:.1f} TFLOP/s in the graph")
        del q, k, v, out, lse, ref, ref_lse, err
    return {"rows": rows}


def phase_ray_cast() -> dict:
    from dreammat_tpu_torch.models.mesh import make_icosphere
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    mesh = make_icosphere(6, device="cuda")
    bvh = bvh_lib.build_bvh(mesh.v_pos.cpu().numpy(), mesh.t_pos_idx.cpu().numpy(), device="cuda")
    tri = bvh_lib._plane_tri_data(bvh)
    T = tri[0].shape[1]
    clock = sm_clock_hz()
    rows = []
    for label, o, d in ray_cast_cases(mesh):
        R = o.shape[0]
        # the pairs the kernel's cull keeps, counted by the kernel
        pairs_t = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri, pairs_out=pairs_t)
        ref = bvh_lib.cast_rays_plain(bvh, o, d, chunk=2048, tri_data=tri)
        torch.cuda.synchronize()
        diff = cast_disagreement(got, ref)
        if any(diff.values()):
            raise AssertionError(f"ray cast {label}: kernel and plain version differ: {diff}")
        ms = cuda_ms(lambda: bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri), 3)
        plain_ms = cuda_ms(lambda: bvh_lib.cast_rays_plain(bvh, o, d, chunk=2048, tri_data=tri), 1,
                           warmup=0)
        pairs = float(pairs_t.item())
        bounds = cast_bounds(pairs, R, T, clock)
        rows.append(dict(label=label, R=R, T=T, pairs=pairs, **diff, ms=ms, plain_ms=plain_ms,
                         **bounds, sm_clock_mhz=clock / 1e6,
                         hit_frac=float(got["hit"].float().mean())))
        log(f"ray cast {label}: R={R} T={T} hits {rows[-1]['hit_frac']:.3f}, flips "
            f"{diff['flips']}, max|dt| {diff['t_err']:.3e}, face and u, v equal | pairs the "
            f"kernel tested {pairs:.4g} ({100.0 * pairs / (float(R) * T):.2f}% of R x T) | kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms | {pairs / ms / 1e6:.1f} Gpairs/s tested, "
            f"{float(R) * T / ms / 1e6:.1f} Gpairs/s of R x T | bound {bounds['bound_ms']:.4f} ms "
            f"({bounds['by']}, {CAST_OPS_PER_PAIR} ops per tested pair at {clock / 1e6:.0f} MHz), "
            f"over all R x T pairs {bounds['bound_all_pairs_ms']:.3f} ms")
        del got, ref
    return {"rows": rows, "clock": clock}


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                                 dim=0).item()


def phase_attention_bwd(gen: torch.Generator, batch: int) -> dict:
    """Kernels C and D against the plain backward (fp32 FlashAttention-2
    equations) at the training shapes; tolerance cosine >= 0.999 and max
    error <= 2e-2 max|ref| for each of dq, dk, dv (the kernels round p and ds
    to bf16 before their products, as the TPU kernels do)."""
    import torch.nn.functional as F

    from dreammat_tpu_torch.ops import attention as attn

    D = ATTN_D
    cases = [(batch, N, M, H) for N, M, H in TRAIN_ATTN_SHAPES] + [(3, 4096, 4096, 5)]
    rows = []
    for B, N, M, H in cases:
        q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (N, M, M))
        do = torch.randn(B, N, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = attn.flash_attention_fwd(q, k, v)
        delta = attn._delta(out, do)
        dq = attn.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        ref = attn.attention_backward_plain(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        errs = {}
        for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            e = (got.float() - r).abs()
            errs[name] = dict(max=e.max().item(), mean=e.mean().item(), cos=_cosine(got, r),
                              ref_max=r.abs().max().item())
            if not (errs[name]["cos"] >= 0.999 and errs[name]["max"] <= 2e-2 * errs[name]["ref_max"]):
                raise AssertionError(f"attention backward B={B} N={N} M={M} H={H} {name}: "
                                     f"{errs[name]}")
        del ref
        iters = 20 if B * H * N * M >= 1 << 27 else 50
        dq_fn = lambda: attn.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        dkv_fn = lambda: attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        dq_ms, dkv_ms = cuda_ms(dq_fn, iters), cuda_ms(dkv_fn, iters)
        dq_g, dkv_g = graph_ms(dq_fn), graph_ms(dkv_fn)
        dq_h, dkv_h = host_us(dq_fn), host_us(dkv_fn)
        plain_ms = cuda_ms(lambda: attn.attention_backward_plain(q, k, v, out, lse, do), 3)
        # yardstick: autograd backward of SDPA (its forward done once, outside
        # the timing), for dq alone and for dk, dv
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        lib = {}
        for label, need in (("dq", (True, False, False)), ("dkv", (False, True, True))):
            xs = [x.detach().requires_grad_(n) for x, n in zip((qt, kt, vt), need)]
            o_lib = F.scaled_dot_product_attention(*xs)
            wrt = [x for x in xs if x.requires_grad]
            lib[label] = cuda_ms(lambda: torch.autograd.grad(o_lib, wrt, dot, retain_graph=True),
                                 iters)
            lib[label + "_host"] = host_us(
                lambda: torch.autograd.grad(o_lib, wrt, dot, retain_graph=True))
            del o_lib
            lib[label + "_graph"] = sdpa_grad_graph_ms(qt, kt, vt, dot, need)
        io_q = 2.0 * B * H * D * N
        io_kv = 2.0 * B * H * D * M
        stats = 8.0 * B * H * N
        bounds = {}
        for label, flops, nbytes in (
                ("dq", 6.0 * B * H * N * M * D, 3 * io_q + 2 * io_kv + stats),
                ("dkv", 8.0 * B * H * N * M * D, 2 * io_q + 4 * io_kv + stats)):
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            bounds[label] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                             flops)
        rows.append(dict(B=B, N=N, M=M, H=H, errs=errs, dq_ms=dq_ms, dkv_ms=dkv_ms,
                         dq_graph_ms=dq_g, dkv_graph_ms=dkv_g, dq_host_us=dq_h, dkv_host_us=dkv_h,
                         plain_ms=plain_ms, lib_dq_ms=lib["dq"], lib_dkv_ms=lib["dkv"],
                         lib_dq_graph_ms=lib["dq_graph"], lib_dkv_graph_ms=lib["dkv_graph"],
                         lib_dq_host_us=lib["dq_host"], lib_dkv_host_us=lib["dkv_host"],
                         dq_bound_ms=bounds["dq"][0], dq_by=bounds["dq"][1],
                         dkv_bound_ms=bounds["dkv"][0], dkv_by=bounds["dkv"][1]))
        log(f"attention bwd B={B:2d} N={N:5d} M={M:5d} H={H:2d}: "
            + ", ".join(f"{n} max {e['max']:.2e} mean {e['mean']:.2e} cos {e['cos']:.6f}"
                        for n, e in errs.items())
            + f" | dq {dq_ms:.4f} ms (graph {dq_g:.4f}, host {dq_h:.1f} us; bound "
            f"{bounds['dq'][0]:.4f} {bounds['dq'][1]}, {bounds['dq'][2] / dq_g / 1e9:.1f} "
            f"TFLOP/s; sdpa {lib['dq']:.4f}, graph {lib['dq_graph']:.4f}, host "
            f"{lib['dq_host']:.1f} us), dk/dv {dkv_ms:.4f} ms (graph {dkv_g:.4f}, host "
            f"{dkv_h:.1f} us; bound {bounds['dkv'][0]:.4f} {bounds['dkv'][1]}, "
            f"{bounds['dkv'][2] / dkv_g / 1e9:.1f} TFLOP/s; sdpa {lib['dkv']:.4f}, graph "
            f"{lib['dkv_graph']:.4f}, host {lib['dkv_host']:.1f} us), plain {plain_ms:.4f} ms")
        del q, k, v, do, out, lse, delta, dq, dk, dv

    # autograd through attention() against the plain forward and backward
    B, N, M, H = batch, 256, 77, 10
    xs = [torch.randn(B, n, H, D, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
          for n in (N, M, M)]
    do = torch.randn(B, N, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    out = attn.attention(*xs)
    out.backward(do)
    ref_out, ref_lse = attn._plain_with_lse(*(x.detach() for x in xs))
    ref = attn.attention_backward_plain(*(x.detach() for x in xs), ref_out, ref_lse, do)
    checks = [("out", out.detach(), ref_out.float())] + [
        (f"d{n}", x.grad, r) for n, x, r in zip("qkv", xs, ref)]
    for name, got, r in checks:
        cos, err = _cosine(got, r), (got.float() - r).abs().max().item()
        if not (cos >= 0.999 and err <= 2e-2 * r.abs().max().item()):
            raise AssertionError(f"autograd through attention: {name} cosine {cos}, max {err}")
    log(f"attention autograd B={B} N={N} M={M} H={H}: out, dq, dk, dv within tolerance")
    return {"rows": rows}


def write_controlnet_dataset(root: str, seed: int, res: int = 256, views: int = 16,
                             envs: int = 5) -> str:
    """One object in the native npz layout (f16, as the dataset generator
    writes it) and its prompts.json; returns the prompts file."""
    rng = np.random.default_rng(seed)
    obj = os.path.join(root, "obj0")
    os.makedirs(obj, exist_ok=True)
    u = lambda *shape: rng.random(shape, dtype=np.float32).astype(np.float16)
    np.savez(os.path.join(obj, "data.npz"), colors=u(views, envs, res, res, 3),
             depths=u(views, res, res, 1), normals=u(views, res, res, 3),
             lightmaps=u(views, envs, res, res, 18))
    prompts = os.path.join(root, "prompts.json")
    with open(prompts, "w") as f:
        json.dump({"obj0": "a ceramic vase with a glossy glaze"}, f)
    return prompts


def phase_controlnet(steps: int, batch: int, seed: int, work_dir: str) -> dict:
    import csv
    import shutil

    import dreammat_tpu_torch
    from dreammat_tpu_torch import train_controlnet
    from dreammat_tpu_torch.ops import attention as attn

    data_dir = os.path.join(work_dir, "data")
    out_dir = os.path.join(work_dir, "run")
    shutil.rmtree(work_dir, ignore_errors=True)
    t0 = time.time()
    prompts = write_controlnet_dataset(data_dir, seed)
    log(f"controlnet: synthetic dataset (1 object, 16 views x 5 envs, 256^2, f16) written in "
        f"{time.time() - t0:.1f}s")
    argv = ["--config", TRAIN_CONFIG, "--max-steps", str(steps),
            "sd_cache_dir=null", f"train_data_dir={data_dir}", f"prompt_file_path={prompts}",
            f"controlnet_dir={out_dir}", f"seed={seed}"]
    counters = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    res = train_controlnet.main(argv)
    torch.cuda.synchronize()
    t_main = time.time() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer = res["trainer"]

    want = {name: n * steps for name, n in LAUNCHES_PER_TRAIN_STEP.items()}
    log(f"controlnet: launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"controlnet launches {counts}, expected {want}")
    with open(os.path.join(out_dir, "logs", "metrics.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"controlnet losses {losses}")

    # the same seed re-initializes the same weights: the ControlNet moved,
    # the frozen UNet did not
    ref = dreammat_tpu_torch.find("controlnet-trainer")(trainer.cfg, device="cuda")
    ref.init_params()
    ref_cnet, ref_unet = ref.controlnet.state_dict(), ref.unet.state_dict()
    moved = max((p - ref_cnet[n]).abs().max().item()
                for n, p in trainer.controlnet.state_dict().items())
    unet_same = all(torch.equal(p, ref_unet[n]) for n, p in trainer.unet.state_dict().items())
    del ref, ref_cnet, ref_unet
    if not moved > 0 or not unet_same:
        raise AssertionError(f"controlnet moved {moved}, frozen UNet unchanged {unet_same}")

    # the export loads strictly into the guidance through controlnet_path
    export = res["export"]
    guidance = dreammat_tpu_torch.find("stable-diffusion-dreammat-guidance")(
        {"controlnet_path": os.path.dirname(export), "cache_dir": None}, device="cuda")
    guidance.init_params()
    mine = trainer.controlnet.state_dict()
    loaded = all(torch.equal(p, mine[n].to(p.dtype))
                 for n, p in guidance.controlnets[0].state_dict().items())
    if not loaded:
        raise AssertionError("the guidance's ControlNet differs from the exported one")
    del guidance
    export_gb = os.path.getsize(export) / 1e9

    step_s = trainer.step_seconds
    warm = step_s[1:] if len(step_s) > 1 else step_s
    log(f"controlnet: {steps} steps at batch {batch} in {t_main:.1f}s (init, data, save and "
        f"export included); step seconds {', '.join(f'{x:.4f}' for x in step_s)}, warm mean "
        f"{np.mean(warm):.4f}s; losses {', '.join(f'{x:.6g}' for x in losses)}; ControlNet "
        f"max |moved| {moved:.3e}, frozen UNet bitwise unchanged; export {export_gb:.2f} GB "
        f"loads strictly into the guidance; peak memory {peak_gb:.2f} GB")
    del trainer, res
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"counts": counts, "batch": batch, "warm_step_s": float(np.mean(warm)),
            "step_s": step_s, "peak_gb": peak_gb, "losses": losses, "moved": moved}


def main_overrides(views: int, shape_init: str = "procedural:sphere", shape_params: str = "6"):
    """The overrides of ``configs/dreammat.yaml`` as the smoke run drives
    it: random weights, procedural skies, ``views`` fixed cameras, no
    caches, and the mesh."""
    return [
        "system.prompt_processor.prompt=a ceramic vase",
        "system.prompt_processor.use_cache=false",
        f"system.geometry.shape_init={shape_init}",
        f"system.geometry.shape_init_params={shape_params}",
        "system.guidance.cache_dir=null",
        "system.guidance.controlnet_path=null",
        "system.material.environment_texture=/nonexistent",
        f"data.fix_view_num={views}",
        "data.prerender_cache_dir=null",
    ]


def main_config(views: int):
    """``configs/dreammat.yaml`` on the level-6 icosphere (main path 1)."""
    from dreammat_tpu_torch.utils.config import load_config

    return load_config("configs/dreammat.yaml", main_overrides(views))


def phase_main(steps: int, views: int, out_dir: str) -> dict:
    import csv

    import dreammat_tpu_torch
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    cfg = main_config(views)
    find = dreammat_tpu_torch.find
    torch.cuda.reset_peak_memory_stats()
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd_dq.launches = 0
    attn.flash_attention_bwd_dkv.launches = 0
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
    bwd = attn.flash_attention_bwd_dq.launches + attn.flash_attention_bwd_dkv.launches
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
    if bwd != 0:
        raise AssertionError(f"{bwd} attention backward launches on the DreamMat path "
                             "(CSD stop-gradients the UNet)")
    log("main: 0 attention backward launches (CSD's stop-gradient holds)")

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


def check_file(path: str, magic: bytes, min_bytes: int, tail: bytes = b"") -> int:
    """The file's size, after checking its signature, its end and its size."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(magic) or not data.endswith(tail) or len(data) < min_bytes:
        raise AssertionError(f"{path}: {len(data)} bytes, starts {data[:8]!r}, ends {data[-2:]!r}")
    return len(data)


class StageLaunches:
    """Kernel B's launches and the seconds inside named calls: each wrapped
    function adds the caster's launches made during the call, and the
    call's seconds up to a synchronize, to its stage."""

    def __init__(self):
        self.counts, self.seconds, self._undo = {}, {}, []

    def wrap(self, owner, name: str, stage: str):
        from dreammat_tpu_torch.ops import bvh as bvh_lib

        fn = getattr(owner, name)
        self.counts.setdefault(stage, 0)
        self.seconds.setdefault(stage, 0.0)

        def wrapper(*a, **k):
            before = bvh_lib.cast_rays_dense.launches
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds[stage] += time.time() - t0
                self.counts[stage] += bvh_lib.cast_rays_dense.launches - before

        setattr(owner, name, wrapper)
        self._undo.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


def _cast_case(label, bvh, tri, o, d, clock, check_idx=None):
    """Kernel B on the rays (o, d): its time, the pairs it tested, its
    bound, and the plain caster on ``check_idx`` (all rays if None), which
    must agree bit for bit."""
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    R, T = o.shape[0], tri[0].shape[1]
    pairs_t = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri, pairs_out=pairs_t)
    ms = cuda_ms(lambda: bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri), 3)
    sel = torch.arange(R, device="cuda") if check_idx is None else check_idx
    os_, ds = o[sel].contiguous(), d[sel].contiguous()
    t0 = time.time()
    ref = bvh_lib.cast_rays_plain(bvh, os_, ds, chunk=2048, tri_data=tri)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    sub = {k: v[sel] for k, v in got.items()}
    diff = cast_disagreement(sub, ref)
    if any(diff.values()):
        raise AssertionError(f"ray cast {label}: kernel and plain version differ: {diff}")
    pairs = float(pairs_t.item())
    bounds = cast_bounds(pairs, R, T, clock)
    row = dict(label=label, R=R, T=T, checked=int(sel.shape[0]), pairs=pairs, **diff, ms=ms,
               plain_ms_checked=plain_ms, **bounds, hit_frac=float(got["hit"].float().mean()))
    log(f"ray cast {label}: R={R} T={T} hits {row['hit_frac']:.3f}; {row['checked']} rays "
        f"bit for bit equal to the plain caster (plain {plain_ms:.1f} ms on them) | pairs tested "
        f"{pairs:.4g} ({100.0 * pairs / (float(R) * T):.3f}% of R x T) | kernel {ms:.3f} ms | "
        f"bound {bounds['bound_ms']:.4f} ms ({bounds['by']}), over all R x T "
        f"{bounds['bound_all_pairs_ms']:.3f} ms")
    return row


def _shade_sources(system, dm, n_px: int, n_px_trace: int) -> dict:
    """View 0's first ``n_px`` pixels shaded by the MC estimator
    (is_train=False) with each visibility source, on the card and on the
    CPU from the same inputs (the raytrace source on the CPU's plain caster
    over ``n_px_trace`` pixels); max |colour difference| per source."""
    import dreammat_tpu_torch
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.ops import visibility as vis_lib

    mat, ren = system.material, system.renderer
    gb = dm.data.gbuffers[0]
    cpu_mat = dreammat_tpu_torch.find(system.cfg.material_type)(system.cfg.material, device="cpu")
    with torch.no_grad():
        feats = system.geometry.apply(system.field, gb.fg_pos[:n_px])
        _, a, m, r = mat.features_to_material(feats)
    t0 = time.time()
    pix = vis_lib.bake_pixel_visibility(ren.bvh, gb.fg_pos, gb.fg_normal,
                                        oct_res=ren.cfg.visibility_oct_res)
    torch.cuda.synchronize()
    pixel_bake_s = time.time() - t0
    cpu_bvh = bvh_lib.FlatBVH(*(x.cpu() for x in ren.bvh))
    cpu_tri = tuple(x.cpu() for x in ren.tri_data)

    def cpu_trace(o, d):
        out = bvh_lib.cast_rays_chunked(cpu_bvh, o, d, tri_data=cpu_tri)
        return None, None, out["t"][:, None], out["hit"]

    res = {"pixel_bake_view_s": pixel_bake_s, "pixels": n_px, "pixels_raytrace_cpu": n_px_trace}
    saved = (mat.baked_visibility, mat.ray_trace_fun)
    for source in ("baked", "pixel", "raytrace"):
        n = n_px_trace if source == "raytrace" else n_px
        args = [x[:n] for x in (gb.fg_pos, gb.fg_normal, gb.fg_viewdir)]
        mats = [x[:n] for x in (m, r, a)]
        vis = {"baked": (gb.fg_tri[:n], gb.fg_bary[:n]),
               "pixel": vis_lib.PixelVisibility(pix.table[:n], pix.oct_res),
               "raytrace": None}[source]
        mat.set_baked_visibility(saved[0] if source == "baked" else None)
        mat.set_raytracer(ren.trace if source == "raytrace" else None)
        cpu_mat.set_baked_visibility(None if source != "baked" else vis_lib.BakedVisibility(
            saved[0].table.cpu(), saved[0].oct_res))
        cpu_mat.set_raytracer(cpu_trace if source == "raytrace" else None)
        cpu_vis = {"baked": (gb.fg_tri[:n].cpu(), gb.fg_bary[:n].cpu()),
                   "pixel": vis_lib.PixelVisibility(pix.table[:n].cpu(), pix.oct_res),
                   "raytrace": None}[source]
        with torch.no_grad():
            t0 = time.time()
            gpu = mat.shade_raytracing(*args, 0, *mats[:2], mats[2], None, is_train=False,
                                       mask=gb.fg_valid[:n], vis_data=vis)["color"]
            torch.cuda.synchronize()
            gpu_s = time.time() - t0
            t0 = time.time()
            cpu = cpu_mat.shade_raytracing(*(x.cpu() for x in args), 0,
                                           *(x.cpu() for x in mats), None, is_train=False,
                                           mask=gb.fg_valid[:n].cpu(), vis_data=cpu_vis)["color"]
            cpu_s = time.time() - t0
        err = (gpu.cpu() - cpu).abs()
        res[source] = {"max_abs": err.max().item(), "share_within_1e-4": float(
            (err.amax(-1) <= 1e-4).float().mean()), "card_s": gpu_s, "cpu_s": cpu_s, "pixels": n}
        log(f"launch: {n} pixels of view 0, MC (is_train=False) with {source} visibility, card vs "
            f"CPU: max |colour diff| {res[source]['max_abs']:.3e}, "
            f"{100 * res[source]['share_within_1e-4']:.2f}% of pixels within 1e-4 "
            f"(card {gpu_s:.3f} s, CPU {cpu_s:.2f} s)")
    # raytrace on all n_px pixels, on the card: the tracer through kernel B
    # against the same estimator with the plain caster as its tracer
    def plain_trace(o, d):
        out = bvh_lib.cast_rays_plain(ren.bvh, o, d, chunk=2048, tri_data=ren.tri_data)
        return None, None, out["t"][:, None], out["hit"]

    mat.set_baked_visibility(None)
    args = [x[:n_px] for x in (gb.fg_pos, gb.fg_normal, gb.fg_viewdir)]
    colours, secs = {}, {}
    for name, tracer in (("kernel", ren.trace), ("plain", plain_trace)):
        mat.set_raytracer(tracer)
        with torch.no_grad():
            t0 = time.time()
            colours[name] = mat.shade_raytracing(*args, 0, m, r, a, None, is_train=False,
                                                 mask=gb.fg_valid[:n_px], vis_data=None)["color"]
            torch.cuda.synchronize()
            secs[name] = time.time() - t0
    err = (colours["kernel"] - colours["plain"]).abs()
    res["raytrace_card"] = {"max_abs": err.max().item(), "share_within_1e-6": float(
        (err.amax(-1) <= 1e-6).float().mean()), "kernel_s": secs["kernel"],
        "plain_s": secs["plain"], "pixels": n_px}
    log(f"launch: {n_px} pixels of view 0, MC (is_train=False) with raytrace visibility on the "
        f"card, tracer kernel B vs the plain caster: max |colour diff| "
        f"{res['raytrace_card']['max_abs']:.3e} (kernel {secs['kernel']:.3f} s, plain "
        f"{secs['plain']:.2f} s)")
    mat.set_baked_visibility(saved[0])
    mat.set_raytracer(saved[1])
    return res


def phase_launch(out_dir: str, clock: float) -> dict:
    """Main path 3: ``launch_torch.py --train`` on a self-occluding torus."""
    import csv
    import shutil

    import launch_torch
    from dreammat_tpu_torch.data.datamodule import RandomCameraDataModule
    from dreammat_tpu_torch.models import exporter as exporter_lib
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj
    from dreammat_tpu_torch.models.renderer import RaytraceRenderer
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.utils import ops as uops

    work = os.path.join("outputs", "chip_smoke_launch")
    shutil.rmtree(work, ignore_errors=True)
    v, f = torus_arrays(0.7, 0.28, 192, 96)
    obj = write_obj(os.path.join(work, "torus.obj"), v, f)
    V, F = v.shape[0], f.shape[0]
    steps = 3
    argv = ["--config", "configs/dreammat.yaml", "--train", "--device", "cuda",
            *main_overrides(4, f"mesh:{obj}", "1.0"),
            "data.fix_env_num=5", f"trainer.max_steps={steps}", "data.hybrid_mc_every=2",
            "data.n_test_views=2", f"exp_root_dir={work}", "use_timestamp=false"]
    stages = StageLaunches()
    stages.wrap(RandomCameraDataModule, "_fastpath_gate", "gate")
    stages.wrap(RaytraceRenderer, "build_gbuffer", "test_gbuffers")
    stages.wrap(exporter_lib, "rasterize_uv_texels", "texel_bake")
    for fn in (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
               attn.flash_attention_bwd_dkv, bvh_lib.cast_rays_dense):
        fn.launches = 0
    t0 = time.time()
    try:
        res = launch_torch.main(argv)
    finally:
        stages.restore()
    torch.cuda.synchronize()
    t_all = time.time() - t0
    counts = {"flash_attn_fwd": attn.flash_attention_fwd.launches,
              "ray_cast": bvh_lib.cast_rays_dense.launches}
    bwd = attn.flash_attention_bwd_dq.launches + attn.flash_attention_bwd_dkv.launches
    system, dm, trial = res["system"], res["datamodule"], res["trial_dir"]
    log(f"launch: launch_torch.py --train on the torus ({V} vertices, {F} triangles) in "
        f"{t_all:.1f}s; launches {counts}, kernel B by stage {stages.counts}")

    gate = dm.gate
    if gate.get("rmse") is None or gate.get("grad_cos") is None:
        raise AssertionError(f"the fast-path gate did not run: {gate}")
    log(f"launch: gate: self-occlusion {100 * gate['occlusion']:.2f}%, relative colour RMSE "
        f"{gate['rmse']:.4f} ({gate['rmse_s']:.2f}s), grad-cos {gate['grad_cos']:.4f} "
        f"({gate['grad_cos_s']:.2f}s), decision: {gate['decision']}; {gate['seconds']:.2f}s")
    for stage, n in stages.counts.items():
        if n <= 0:
            raise AssertionError(f"kernel B was not launched in the stage {stage}")
    if counts["flash_attn_fwd"] != 46 * steps or bwd != 0:
        raise AssertionError(f"kernel A launches {counts['flash_attn_fwd']} (expected "
                             f"{46 * steps}), backward launches {bwd}")

    with open(os.path.join(trial, "logs", "metrics.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"logged losses {losses}")
    if not all(math.isfinite(x) for x in system.step_losses):
        raise AssertionError(f"losses {system.step_losses}")
    ref = system.geometry.init(torch.Generator(device="cuda").manual_seed(res["cfg"].seed))
    moved = max((p.detach() - q.detach()).abs().max().item()
                for p, q in zip(system.field.parameters(), ref.parameters()))
    if not moved > 0:
        raise AssertionError("the field did not move")

    save = os.path.join(trial, "save")
    sizes = {}
    for i in range(2):
        for sub in ("", "albedo", "roughness", "metallic"):
            path = os.path.join(save, f"it{steps}-test", sub, f"{i}.png")
            sizes[os.path.relpath(path, save)] = check_file(path, b"\x89PNG\r\n\x1a\n", 1000)
    sizes["gif"] = check_file(os.path.join(save, f"it{steps}-test.gif"), b"GIF89a", 1000, b";")
    exp = os.path.join(save, "export")
    for name in ("texture_kd.jpg", "texture_metallic.jpg", "texture_roughness.jpg"):
        sizes[name] = check_file(os.path.join(exp, name), b"\xff\xd8\xff", 10000, b"\xff\xd9")
    sizes["model.mtl"] = check_file(os.path.join(exp, "model.mtl"), b"newmtl model", 100)
    with open(os.path.join(exp, "model.obj")) as f:
        kinds = [line.split(" ", 1)[0] for line in f]
    got = {k: kinds.count(k) for k in ("v", "vt", "vn", "f")}
    want = {"v": V, "vt": 3 * F, "vn": V, "f": F}
    if got != want:
        raise AssertionError(f"model.obj holds {got}, expected {want}")
    log(f"launch: files: {sizes}; model.obj v/vt/vn/f {got}")

    # kernel B against the plain caster on the gate's shadow rays and the texel bake
    mat, ren = system.material, system.renderer
    gb = dm.data.gbuffers[0]
    P = gb.fg_pos.shape[0]
    m = torch.full((P, 1), 0.5, device="cuda")
    r = torch.full((P, 1), 0.3, device="cuda")
    refl = uops.reflect(gb.fg_viewdir, gb.fg_normal)
    dirs = torch.cat([mat.sample_diffuse_directions(gb.fg_normal),
                      mat.sample_specular_directions(refl, r)], dim=1).reshape(-1, 3)
    pts = gb.fg_pos[:, None].expand(-1, dirs.shape[0] // P, 3).reshape(-1, 3)
    so, sd = (pts + dirs * 1e-5).contiguous(), dirs.contiguous()
    n_check = 65536
    pick = torch.arange(n_check, device="cuda") * (so.shape[0] // n_check)
    shadow = _cast_case(f"gate shadow rays ({P} px x {dirs.shape[0] // P})", ren.bvh,
                        ren.tri_data, so, sd, clock, pick)
    del so, sd, pts, dirs
    res_tex = system.exporter.cfg.texture_size
    ubvh, uo, ud = exporter_lib.uv_texel_rays(*system.exporter.uv, res_tex, device="cuda")
    lo = res_tex // 2 - 128
    grid = torch.arange(res_tex * res_tex, device="cuda").reshape(res_tex, res_tex)
    block = grid[lo:lo + 256, lo:lo + 256].reshape(-1)
    texel = _cast_case(f"texel bake {res_tex}^2", ubvh, bvh_lib._plane_tri_data(ubvh), uo, ud,
                       clock, block)
    del uo, ud

    shading = _shade_sources(system, dm, 4096, 32)
    for source in ("baked", "pixel", "raytrace"):
        if shading[source]["share_within_1e-4"] < 0.999:
            raise AssertionError(f"card vs CPU shading with {source} visibility: {shading[source]}")
    if shading["raytrace_card"]["max_abs"] > 1e-6:
        raise AssertionError(f"raytrace shading, kernel B vs plain tracer: {shading['raytrace_card']}")

    step_s = system.step_seconds
    kinds = system.step_kinds
    peaks = system.step_peak_gb
    table_i = [i for i, k in enumerate(kinds) if k == "tables"]
    mc_i = [i for i, k in enumerate(kinds) if k == "mc"]
    warm_mc = [i for i in mc_i if i > 0]
    timing = {
        "prerender_s": dict(dm.data.seconds), "gate_s": gate["seconds"],
        "pixel_bake_view_s": shading["pixel_bake_view_s"],
        "step_s": step_s, "step_kinds": kinds, "step_peak_gb": peaks,
        "warm_table_step_s": step_s[table_i[-1]] if table_i else None,
        "warm_mc_step_s": step_s[warm_mc[-1]] if warm_mc else None,
        "table_step_peak_gb": max(peaks[i] for i in table_i) if table_i else None,
        "mc_step_peak_gb": max(peaks[i] for i in mc_i) if mc_i else None,
        "test_s_per_view": system.test_seconds, "export_s": dict(system.exporter.seconds),
    }
    log(f"launch: prerender {', '.join(f'{k} {v:.3f}s' for k, v in dm.data.seconds.items())}; "
        f"gate {gate['seconds']:.2f}s; pixel bake of view 0 ({P} px x 256) "
        f"{shading['pixel_bake_view_s']:.3f}s")
    log(f"launch: steps {', '.join(f'{k} {s:.4f}s {g:.2f} GB' for k, s, g in zip(kinds, step_s, peaks))}"
        f"; losses {', '.join(f'{x:.6g}' for x in system.step_losses)}; field max |moved| "
        f"{moved:.3e}")
    log(f"launch: test renders {', '.join(f'{x:.3f}s' for x in system.test_seconds)} per view; "
        f"export {', '.join(f'{k} {v:.3f}s' for k, v in system.exporter.seconds.items())}")
    del system, dm, res
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"counts": counts, "stage_launches": dict(stages.counts), "gate": gate,
            "losses": losses, "timing": timing, "shading": shading,
            "ray_cast": [shadow, texel], "files": sizes}


# ---------------------------------------------------------------------------
# main path 4: DreamMat from a user's own files
# ---------------------------------------------------------------------------

USER_LIBRARY = {"materials": {"ceramic_torus": "a glazed ceramic ring with thin gold trim"}}
USER_PERPNEG_SCALE = 1.0


def tensor_checksum(t: torch.Tensor) -> float:
    """A per-tensor checksum that a permutation changes: the float64 sum of
    the values weighted by 1 + (index mod 7)."""
    flat = t.detach().reshape(-1).double()
    return float((flat * (1.0 + torch.arange(flat.numel(), device=flat.device) % 7)).sum())


def write_user_weights(root: str, device, size: str, held_dtype, seed: int = 0) -> dict:
    """Random weights in the diffusers layout, fp16 safetensors through the
    port's writer: ``unet/`` and ``vae/`` (the VAE's attention under the old
    names query / key / value / proj_attn, as 1x1 convolutions) and
    ``text_encoder/`` (with a ``position_ids`` buffer). Returns, per model
    and key, the checksum of the values as the port holds them (the UNet
    and the VAE in ``held_dtype``, CLIP in fp32)."""
    from dreammat_tpu_torch.models.diffusion import convert
    from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
    from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
    from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
    from dreammat_tpu_torch.utils.safetensors_io import save_file

    sd21 = size == "sd21"
    specs = [
        ("unet", "diffusion_pytorch_model", held_dtype,
         lambda: UNet2DCondition(UNetConfig.sd21() if sd21 else UNetConfig.tiny())),
        ("vae", "diffusion_pytorch_model", held_dtype,
         lambda: AutoencoderKL(VAEConfig.sd() if sd21 else VAEConfig.tiny())),
        ("text_encoder", "model", torch.float32,
         lambda: CLIPTextModel(CLIPTextConfig.sd21() if sd21 else CLIPTextConfig.tiny())),
    ]
    gen = torch.Generator(device=device).manual_seed(seed)
    sums, nbytes = {}, 0
    for sub, fname, held, build in specs:
        module = convert.random_init_(convert.build_on(build, device, torch.float16), gen)
        sd = dict(module.state_dict())
        sums[sub] = {k: tensor_checksum(v.to(held)) for k, v in sd.items()}
        if sub == "vae":
            old = {}
            for k, v in sd.items():
                for new, legacy in convert._VAE_ALIASES:
                    if f".{new}." in k:
                        k, v = k.replace(new, legacy), v[:, :, None, None] if v.dim() == 2 else v
                old[k] = v
            sd = old
        if sub == "text_encoder":
            n_pos = sd["text_model.embeddings.position_embedding.weight"].shape[0]
            sd["text_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        save_file(sd, os.path.join(root, sub, f"{fname}.safetensors"))
        nbytes += sum(v.numel() * v.element_size() for v in sd.values())
        del module, sd
    sums["bytes"] = nbytes
    return sums


def write_user_envmaps(root: str, n: int, height: int, width: int, seed: int = 0) -> str:
    """``n`` RGBE maps ``map{i}/map{i}.hdr``: a sky with a sun of its own
    per map, times a little texture noise."""
    from dreammat_tpu_torch.ops.envmap import make_procedural_envmap, write_hdr

    rng = np.random.default_rng(seed)
    for i in range(n):
        sun = rng.normal(size=3)
        sun[2] = abs(sun[2]) + 0.3
        sky = make_procedural_envmap(height, width, sun_dir=sun, sun_intensity=8.0 + 4.0 * i,
                                     sky_color=tuple(rng.uniform(0.2, 0.7, 3)))
        sky = sky * rng.uniform(0.8, 1.2, (height, width, 1)).astype(np.float32)
        os.makedirs(os.path.join(root, f"map{i + 1}"), exist_ok=True)
        write_hdr(os.path.join(root, f"map{i + 1}", f"map{i + 1}.hdr"), sky)
    return root


def user_files_argv(work: str, mesh: str, config: str, device: str, views: int,
                    steps: int) -> list:
    """``launch_torch.py --train`` on the user's files under ``work``."""
    return ["--config", config, "--train", "--device", device,
            f"system.geometry.shape_init=mesh:{mesh}", "system.geometry.shape_init_params=1.0",
            "system.prompt_processor.prompt=lib:ceramic_torus",
            f"system.prompt_processor.prompt_library_path={work}/prompt_library.json",
            f"system.prompt_processor.pretrained_model_cache_dir={work}/model",
            "system.prompt_processor.use_cache=true",
            f"system.prompt_processor.cache_dir={work}/text_embeddings",
            "system.prompt_processor.use_perp_neg=true",
            f"system.guidance.cache_dir={work}/model", "system.guidance.controlnet_path=null",
            f"system.guidance.perpneg_scale={USER_PERPNEG_SCALE}",
            f"system.material.environment_texture={work}/envmap",
            "system.optimizer.name=Adan",
            f"data.fix_view_num={views}", f"data.prerender_cache_dir={work}/prerender",
            "data.n_test_views=1", f"trainer.max_steps={steps}",
            f"exp_root_dir={work}/runs", "use_timestamp=false"]


def drive_user_files(work: str, device: str = "cuda", size: str = "sd21", views: int = 4,
                     steps: int = 2, env_hw=(256, 512), torus=(192, 96),
                     datagen_views: int = 4, datagen_res: int = 256) -> dict:
    """Main path 4 through the user's entry points: write the user's files
    (SD weights, five HDR maps, the torus as .glb and .ply, a prompt
    library), run ``launch_torch.py --train`` on them twice in this process
    (Perp-Neg, Adan, the embedding and the prerender caches; the export is
    left to main path 3), check the weights the first run holds and the
    caches the second run hits, then generate a ControlNet dataset from the
    .glb with ``generate_controlnet_data_torch.py`` and load it through
    ``ControlNetDataset``. Returns what was measured; raises on a failed
    check."""
    import shutil

    import generate_controlnet_data_torch
    import launch_torch
    from dreammat_tpu_torch.data import prerender as prerender_lib
    from dreammat_tpu_torch.data.controlnet_dataset import ControlNetDataset
    from dreammat_tpu_torch.models import mesh as mesh_lib
    from dreammat_tpu_torch.models.guidance import StableDiffusionLightGuidance
    from dreammat_tpu_torch.models.prompt import StableDiffusionPromptProcessor
    from dreammat_tpu_torch.systems.dreammat import DreamMat

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config = "configs/dreammat.yaml" if size == "sd21" else "configs/dreammat_tiny.yaml"
    held = torch.bfloat16 if size == "sd21" else torch.float32  # half_precision_weights
    shutil.rmtree(work, ignore_errors=True)
    res = {"seconds": {}}
    t0 = time.time()
    sums = write_user_weights(os.path.join(work, "model"), device, size, held)
    res["seconds"]["write_weights"] = time.time() - t0
    res["weights_gb"] = sums.pop("bytes") / 1e9
    write_user_envmaps(os.path.join(work, "envmap"), 5, *env_hw)
    v, f = mesh_lib.torus_arrays(0.7, 0.28, *torus)
    glb = mesh_lib.write_glb(os.path.join(work, "meshes", "torus.glb"), v, f)
    ply = mesh_lib.write_ply(os.path.join(work, "ply", "torus.ply"), v, f)
    for path in (glb, ply):
        lv, lf, _, _ = mesh_lib._LOADERS[os.path.splitext(path)[1]](path)
        if not (np.array_equal(lv, v) and np.array_equal(lf, f)):
            raise AssertionError(f"{path} does not load back to the torus it holds")
    m_glb = mesh_lib.load_mesh(glb, 1.0, device="cpu")
    m_ply = mesh_lib.load_mesh(ply, 1.0, device="cpu")
    if not (torch.equal(m_glb.v_pos, m_ply.v_pos) and torch.equal(m_glb.t_pos_idx,
                                                                 m_ply.t_pos_idx)):
        raise AssertionError("the .glb and the .ply of the torus load to different meshes")
    with open(os.path.join(work, "prompt_library.json"), "w") as fh:
        json.dump(USER_LIBRARY, fh)
    log(f"user files: {res['weights_gb']:.2f} GB of fp16 weights (unet, vae with the old "
        f"attention names, text_encoder) written in {res['seconds']['write_weights']:.1f}s; 5 "
        f"HDR maps {env_hw[0]}x{env_hw[1]}; the torus ({len(v)} vertices, {len(f)} triangles) "
        f"as .glb and .ply, loaded back equal; a prompt library")

    argv = user_files_argv(work, glb, config, device, views, steps)
    stages = StageLaunches()
    stages.wrap(StableDiffusionLightGuidance, "init_params", "load_sd_weights")
    stages.wrap(StableDiffusionPromptProcessor, "__call__", "prompt_embeddings")
    real_export = DreamMat.export
    DreamMat.export = lambda self, *a, **k: None  # main path 3 covers the export
    runs = []
    try:
        for r in range(2):
            for stage in stages.seconds:
                stages.seconds[stage] = 0.0
            t0 = time.time()
            out = launch_torch.main(argv)
            sync()
            system, dm = out["system"], out["datamodule"]
            run = {"seconds": time.time() - t0, "stage_s": dict(stages.seconds),
                   "prerender_s": dict(dm.data.seconds), "from_cache": dm.data.from_cache,
                   "prompt_cache_hits": system.prompt_processor.cache_hits,
                   "step_s": list(system.step_seconds), "losses": list(system.step_losses),
                   "step_kinds": list(system.step_kinds), "gate": dm.gate.get("decision"),
                   "step_peak_gb": list(system.step_peak_gb)}
            if not all(math.isfinite(x) for x in system.step_losses) \
                    or len(system.step_losses) != steps:
                raise AssertionError(f"run {r}: losses {system.step_losses}")
            if system.prompt_processor.prompt != USER_LIBRARY["materials"]["ceramic_torus"]:
                raise AssertionError(f"lib: prompt resolved to {system.prompt_processor.prompt!r}")
            if not (system.prompt_utils.use_perp_neg
                    and type(system.optimizer).__name__ == "Adan"):
                raise AssertionError("the run did not use Perp-Neg and Adan")
            envs, mcfg = system.material.envs, system.material.cfg
            if tuple(envs.shape) != (mcfg.n_environments, mcfg.env_height, mcfg.env_width, 3) \
                    or not bool(torch.isfinite(envs).all()):
                raise AssertionError(f"environments {tuple(envs.shape)}")
            if r == 0:
                run.update(check_user_weights(system, sums))
                first_maps = {k: getattr(dm.data, k).clone()
                              for k in ("lightmaps", "depths", "normals", "table_spec")}
                if dm.data.from_cache or run["prompt_cache_hits"]:
                    raise AssertionError("the first run found caches it should have written")
            else:
                if not dm.data.from_cache or system.prompt_processor.text_encoder is not None \
                        or run["prompt_cache_hits"] != 11:
                    raise AssertionError(f"the second run missed a cache: prerender "
                                         f"{dm.data.from_cache}, prompt embeddings "
                                         f"{run['prompt_cache_hits']} of 11")
                q = prerender_lib.quantize_for_cache(first_maps["lightmaps"],
                                                     first_maps["depths"], first_maps["normals"])
                for name, qx, top in zip(("lightmaps", "depths", "normals"), q,
                                         (255.0, 65535.0, 255.0)):
                    want = (qx.float() / top).half()
                    if not torch.equal(getattr(dm.data, name), want):
                        raise AssertionError(f"cached {name} differ from the first run's")
                if not torch.equal(dm.data.table_spec, first_maps["table_spec"]):
                    raise AssertionError("cached specular tables differ from the first run's")
                res["glb_view"] = (system.renderer, dm.cameras)
            runs.append(run)
            log(f"user files: run {r}: launch_torch.py --train in {run['seconds']:.1f}s; "
                f"loading the SD weights {run['stage_s']['load_sd_weights']:.2f}s, prompt "
                f"embeddings {run['stage_s']['prompt_embeddings']:.2f}s ({run['prompt_cache_hits']}"
                f" from the cache); prerender "
                + ", ".join(f"{k} {x:.3f}s" for k, x in run["prerender_s"].items())
                + f" ({'from the npz cache' if run['from_cache'] else 'rendered'}); gate: "
                f"{run['gate']}; steps {', '.join(f'{x:.4f}s' for x in run['step_s'])} "
                f"({', '.join(run['step_kinds'])}; peak "
                f"{', '.join(f'{x:.2f} GB' for x in run['step_peak_gb'])}), losses "
                f"{', '.join(f'{x:.6g}' for x in run['losses'])}")
            del out, system, dm
            if cuda:
                torch.cuda.empty_cache()
    finally:
        DreamMat.export = real_export
        stages.restore()
    res["runs"] = runs

    t0 = time.time()
    gen = generate_controlnet_data_torch.main([
        "--meshes-dir", os.path.dirname(glb), "--out", os.path.join(work, "controlnet_data"),
        "--views", str(datagen_views), "--envs", "5", "--resolution", str(datagen_res),
        "--env-dir", os.path.join(work, "envmap"), "--device", device])
    sync()
    res["seconds"]["datagen"] = time.time() - t0
    ds = ControlNetDataset(gen["out"], os.path.join(gen["out"], "prompts.json"),
                           resolution=datagen_res, env_num=5, view_num=datagen_views)
    items = [ds[i] for i in range(len(ds))]
    if len(items) != datagen_views * 5 or any(
            it.target.shape != (datagen_res, datagen_res, 3)
            or it.condition.shape != (datagen_res, datagen_res, 22)
            or not (np.isfinite(it.target).all() and np.isfinite(it.condition).all())
            for it in items):
        raise AssertionError("the generated ControlNet dataset has a wrong shape or a "
                             "non-finite value")
    fg = float(np.mean([(it.target < 1).any(-1).mean() for it in items]))
    log(f"user files: ControlNet dataset {datagen_views} views x 5 envs at {datagen_res}^2 from "
        f"the .glb generated in {res['seconds']['datagen']:.2f}s; {len(items)} items load "
        f"through ControlNetDataset, finite, object on {100 * fg:.1f}% of the target pixels")
    res["datagen_items"] = len(items)
    return res


def check_user_weights(system, sums: dict) -> dict:
    """Every tensor the guidance's UNet and VAE and the prompt processor's
    CLIP hold equals what was written (after the cast), by checksum, and
    each load's key count is its model's."""
    g, pp = system.guidance, system.prompt_processor
    out = {}
    for kind, module, report in (("unet", g.unet, g.loaded.get("unet")),
                                 ("vae", g.vae, g.loaded.get("vae")),
                                 ("text_encoder", pp.text_encoder, pp.loaded)):
        if report is None:
            raise AssertionError(f"{kind}: no checkpoint was loaded")
        own = module.state_dict()
        if len(report["loaded"]) != len(own) or report["missing"] or report["unused"]:
            raise AssertionError(f"{kind}: {len(report['loaded'])} of {len(own)} keys loaded, "
                                 f"missing {report['missing'][:4]}, unused {report['unused'][:4]}")
        bad = [k for k, v in own.items() if tensor_checksum(v) != sums[kind][k]]
        if bad:
            raise AssertionError(f"{kind}: {len(bad)} tensors differ from the file, e.g. {bad[:4]}")
        out[f"{kind}_keys"] = len(own)
    log(f"user files: the guidance holds the written UNet ({out['unet_keys']} tensors) and VAE "
        f"({out['vae_keys']}, from the old attention names), the prompt processor the written "
        f"CLIP ({out['text_encoder_keys']}): every key loaded, every checksum equal")
    return out


def phase_user_files(clock: float) -> dict:
    """Main path 4 on the card (``drive_user_files`` at SD2.1 width, 512^2,
    4 views, 2 steps), its kernel launches, then kernel A against its
    plain version at the Perp-Neg batch (B = 5, N = M = 4096, H = 5; times
    beside SDPA's) and kernel B bit for bit on one 512^2 G-buffer view of
    the .glb mesh."""
    import torch.nn.functional as F

    from dreammat_tpu_torch.models.renderer import _views_rays
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    work = os.path.join("outputs", "chip_smoke_user")
    for fn in (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
               attn.flash_attention_bwd_dkv, bvh_lib.cast_rays_dense):
        fn.launches = 0
    res = drive_user_files(work)
    counts = {"flash_attn_fwd": attn.flash_attention_fwd.launches,
              "ray_cast": bvh_lib.cast_rays_dense.launches}
    bwd = attn.flash_attention_bwd_dq.launches + attn.flash_attention_bwd_dkv.launches
    log(f"user files: launches {counts}, attention backward {bwd}")
    steps = sum(len(r["step_s"]) for r in res["runs"])
    if counts["flash_attn_fwd"] != 46 * steps or counts["ray_cast"] <= 0 or bwd:
        raise AssertionError(f"path 4 launches {counts} (kernel A expected {46 * steps}), "
                             f"backward {bwd}")
    res["counts"] = counts

    # kernel A at the Perp-Neg batch
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, N, H, D = 5, 4096, 5, ATTN_D
    q, k, v = (torch.randn(B, N, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out, lse = attn.flash_attention_fwd(q, k, v)
    ref, ref_lse = attn._plain_with_lse(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    a5 = {"B": B, "N": N, "M": N, "H": H, "max_err": err.max().item(),
          "mean_err": err.mean().item(), "lse_err": (lse - ref_lse).abs().max().item()}
    if not (a5["max_err"] <= 2e-2 and a5["mean_err"] <= 2e-3 and a5["lse_err"] <= 1e-3):
        raise AssertionError(f"kernel A at B=5: {a5}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kern = lambda: attn.flash_attention_fwd(q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    flops = 4.0 * B * H * N * N * D
    nbytes = 2.0 * B * H * D * 4 * N + 4.0 * B * H * N
    a5.update(ms=cuda_ms(kern, 20), lib_ms=cuda_ms(sdpa, 20), graph_ms=graph_ms(kern),
              lib_graph_ms=graph_ms(sdpa),
              plain_ms=cuda_ms(lambda: attn._plain_with_lse(q, k, v), 3),
              bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
              by="operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes")
    log(f"attention B=5 N=M=4096 H=5 (Perp-Neg): max|err| {a5['max_err']:.3e} mean "
        f"{a5['mean_err']:.3e} lse {a5['lse_err']:.3e} | kernel {a5['ms']:.4f} ms (graph "
        f"{a5['graph_ms']:.4f}), sdpa {a5['lib_ms']:.4f} ms (graph {a5['lib_graph_ms']:.4f}), "
        f"plain {a5['plain_ms']:.4f} ms, bound {a5['bound_ms']:.4f} ms ({a5['by']})")
    res["attention_b5"] = a5
    del q, k, v, out, lse, ref, ref_lse, err

    # kernel B on one G-buffer view of the .glb mesh, every ray against the plain caster
    ren, cam = res.pop("glb_view")
    f32 = lambda x: torch.as_tensor(np.asarray(x[:1], np.float32), device="cuda")
    _, _, ro, rd = _views_rays(f32(cam.elevation_deg), f32(cam.azimuth_deg),
                               f32(cam.camera_distances), f32(cam.fovy_deg), 512, 512)
    res["ray_cast_view"] = _cast_case("glb torus G-buffer view 512^2", ren.bvh, ren.tri_data,
                                      ro.reshape(-1, 3).contiguous(),
                                      rd.reshape(-1, 3).contiguous(), clock)
    del ren
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# main path 5: the rest of DreamMat's options
# ---------------------------------------------------------------------------

def options_argv(work: str, obj: str, config: str, device: str, run: str, steps: int,
                 views: int) -> list:
    """``launch_torch.py --train`` of main path 5's run ``a`` (random
    cameras with progressive widening and the camera, centre and up
    perturbs, the UV-space field, ``visibility_subdiv=1``, prompt
    debiasing) or ``b`` (the split-sum path on the fixed rig)."""
    base = ["--config", config, "--train", "--device", device,
            *main_overrides(views, f"mesh:{obj}", "1.0"), "data.n_test_views=1",
            f"trainer.max_steps={steps}", f"exp_root_dir={work}/runs_{run}", "use_timestamp=false"]
    if run == "a":
        return base + ["data.use_fix_views=false", "data.progressive_until=2",
                       "data.camera_perturb=0.1", "data.center_perturb=0.05",
                       "data.up_perturb=0.02", "system.geometry.n_input_dims=2",
                       "system.renderer.visibility_subdiv=1",
                       "system.prompt_processor.use_prompt_debiasing=true"]
    return base + ["system.material.use_raytracing=false"]


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def drive_options(work: str, device: str = "cuda", size: str = "sd21", steps_a: int = 4,
                  steps_b: int = 2, views_b: int = 4, torus=(192, 96)) -> dict:
    """Main path 5 through ``launch_torch.py --train`` on the torus of main
    path 3 written with its (u, v) parameterisation as ``vt``: run ``a``
    (random cameras, the UV field, ``visibility_subdiv=1``, prompt
    debiasing; ``steps_a`` steps, 1 test view, the export skipped as the
    UV field cannot be exported) and run ``b`` (the split-sum path, fixed
    rig of ``views_b`` views, ``steps_b`` steps, 1 test view, no export:
    main path 3 has it). Per run: kernel A's and B's launches (B by stage),
    finite losses, the files. Run ``a`` also: one launch of kernel B per
    step, the subdivided mesh against ``subdivide_mesh``, the debiased
    prompts in the log, and the seconds of the subdivided bake, the
    debiasing, each step's G-buffer and probe bake. Run ``b``: the
    split-sum stacks and the seconds of ``build_splitsum`` for every map.
    Returns what was measured and, under ``views``, run a's system and
    data module; raises on a failed check."""
    import shutil

    import launch_torch
    import dreammat_tpu_torch
    from dreammat_tpu_torch.data import prerender as prerender_lib
    from dreammat_tpu_torch.data.datamodule import RandomCameraDataModule
    from dreammat_tpu_torch.models import debias as debias_lib
    from dreammat_tpu_torch.models import mesh as mesh_lib
    from dreammat_tpu_torch.models.material import DreamMatMaterial
    from dreammat_tpu_torch.models.renderer import RaytraceRenderer
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.systems.dreammat import DreamMat

    cuda = torch.device(device).type == "cuda"
    config = "configs/dreammat.yaml" if size == "sd21" else "configs/dreammat_tiny.yaml"
    shutil.rmtree(work, ignore_errors=True)
    v, f = mesh_lib.torus_arrays(0.7, 0.28, *torus)
    vt, ft = mesh_lib.torus_uv_arrays(*torus)
    obj = mesh_lib.write_obj(os.path.join(work, "torus_uv.obj"), v, f, vt, ft)
    res = {"runs": {}}
    real_export = DreamMat.export
    DreamMat.export = lambda self, *a, **k: None  # run b: main path 3 has the export
    lines = _LogLines()
    dreammat_tpu_torch.logger.addHandler(lines)
    try:
        for run, steps, views in (("a", steps_a, 1), ("b", steps_b, views_b)):
            stages = StageLaunches()
            stages.wrap(RaytraceRenderer, "configure", "configure_and_bake")
            stages.wrap(RaytraceRenderer, "build_gbuffers_batched", "fixed_rig_gbuffers")
            stages.wrap(RandomCameraDataModule, "_fastpath_gate", "gate")
            stages.wrap(RaytraceRenderer, "build_gbuffer", "budget_and_test_views")
            stages.wrap(RaytraceRenderer, "build_gbuffer_from_rays", "step_gbuffers")
            stages.wrap(prerender_lib, "probe_view_for_camera", "step_probes")
            stages.wrap(debias_lib, "build_bert_mlm", "bert_build")
            stages.wrap(debias_lib, "get_debiased_prompt", "debiasing")
            stages.wrap(DreamMatMaterial, "ensure_splitsum", "build_splitsum")
            for fn in (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
                       attn.flash_attention_bwd_dkv, bvh_lib.cast_rays_dense):
                fn.launches = 0
            del lines.lines[:]
            t0 = time.time()
            try:
                out = launch_torch.main(options_argv(work, obj, config, device, run, steps,
                                                     views))
            finally:
                stages.restore()
            if cuda:
                torch.cuda.synchronize()
            system, dm, trial = out["system"], out["datamodule"], out["trial_dir"]
            r = {"seconds": time.time() - t0,
                 "launches": {"flash_attn_fwd": attn.flash_attention_fwd.launches,
                              "ray_cast": bvh_lib.cast_rays_dense.launches},
                 "ray_cast_by_stage": dict(stages.counts), "stage_s": dict(stages.seconds),
                 "step_s": list(system.step_seconds), "losses": list(system.step_losses),
                 "step_kinds": list(system.step_kinds), "step_peak_gb": list(system.step_peak_gb)}
            bwd = attn.flash_attention_bwd_dq.launches + attn.flash_attention_bwd_dkv.launches
            if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
                raise AssertionError(f"path 5 run {run}: losses {r['losses']}")
            if cuda and (r["launches"]["flash_attn_fwd"] != 46 * steps or bwd):
                raise AssertionError(f"path 5 run {run}: kernel A {r['launches']}, backward {bwd}"
                                     f" (expected {46 * steps} and 0)")
            if cuda and r["launches"]["ray_cast"] != sum(stages.counts.values()):
                raise AssertionError(f"path 5 run {run}: kernel B {r['launches']['ray_cast']} "
                                     f"launches, by stage {stages.counts}")
            save = os.path.join(trial, "save")
            r["files"] = {name: check_file(os.path.join(save, name), magic, 100, tail)
                          for name, magic, tail in (
                              (f"it{steps}-test/0.png", b"\x89PNG\r\n\x1a\n", b""),
                              (f"it{steps}-test.gif", b"GIF89a", b";"))}
            if run == "a":
                if cuda and stages.counts["step_gbuffers"] != steps:
                    raise AssertionError(f"kernel B launched {stages.counts['step_gbuffers']} "
                                         f"times in {steps} random-camera steps")
                want = mesh_lib.subdivide_mesh(system.geometry.isosurface(), 1)
                got = system.renderer.mesh
                V, F = len(v), len(f)
                counts = {"vertices": got.v_pos.shape[0], "triangles": got.t_pos_idx.shape[0]}
                if counts != {"vertices": want.v_pos.shape[0],
                              "triangles": want.t_pos_idx.shape[0]} \
                        or counts != {"vertices": V + 3 * F // 2, "triangles": 4 * F}:
                    raise AssertionError(f"subdivided mesh {counts}, subdivide_mesh "
                                         f"{want.v_pos.shape[0]} / {want.t_pos_idx.shape[0]}")
                debiased = [x for x in lines.lines if x.startswith("Debiased prompt of the")]
                if len(debiased) != 4 or len(system.prompt_processor.debiased) != 4:
                    raise AssertionError(f"debiased prompts logged: {debiased}")
                if os.path.exists(os.path.join(save, "export")) or not any(
                        x.startswith("export skipped") for x in lines.lines):
                    raise AssertionError("the UV-field run did not skip its export")
                r.update(subdivided=counts, debiased=debiased, budget=dm._random_budget,
                         prompts_vd=list(system.prompt_processor.prompts_vd))
                res["views"] = (system, dm)
                log(f"options a: {V} vertices / {F} triangles subdivided to {counts}; pixel "
                    f"budget {dm._random_budget}; debiased: {'; '.join(debiased)}")
            else:
                ss = system.material.splitsum
                shape = (system.material.envs.shape[0], 7, system.material.cfg.splitsum_height,
                         system.material.cfg.splitsum_width, 3)
                if ss is None or tuple(ss["specular"].shape) != shape or not bool(
                        torch.isfinite(ss["specular"]).all() & torch.isfinite(ss["diffuse"]).all()):
                    raise AssertionError(f"split-sum stacks: want {shape}, finite")
                r["splitsum_shape"] = shape
                del system, dm
            log(f"options {run}: launch_torch.py --train in {r['seconds']:.1f}s; launches "
                f"{r['launches']}, kernel B by stage {r['ray_cast_by_stage']}; stage seconds "
                + ", ".join(f"{k} {x:.3f}" for k, x in r["stage_s"].items() if x)
                + f"; steps {', '.join(f'{x:.4f}s' for x in r['step_s'])} "
                f"({', '.join(r['step_kinds'])}; peak "
                f"{', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])}); losses "
                f"{', '.join(f'{x:.6g}' for x in r['losses'])}")
            res["runs"][run] = r
            del out
            if cuda:
                torch.cuda.empty_cache()
    finally:
        DreamMat.export = real_export
        dreammat_tpu_torch.logger.removeHandler(lines)
    return res


def phase_options(clock: float, fixed_step_s: Optional[float]) -> dict:
    """Main path 5 on the card (``drive_options`` at SD2.1 width, 512^2),
    then kernel B bit for bit against the plain caster on every ray of one
    more sampled camera of run a (perturbs on), on the subdivided torus."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_options")
    res = drive_options(work)
    system, dm = res.pop("views")
    ra = res["runs"]["a"]
    warm = ra["step_s"][1:]
    cam = dm._sample_camera(len(ra["step_s"]))
    ren = system.renderer
    res["ray_cast_sampled_view"] = _cast_case(
        "sampled camera 512^2 (perturbs on), subdivided torus", ren.bvh, ren.tri_data,
        cam["rays_o"].reshape(-1, 3).contiguous(), cam["rays_d"].reshape(-1, 3).contiguous(),
        clock)
    res["timing"] = {
        "random_step_warm_s": float(np.mean(warm)), "fixed_step_warm_s": fixed_step_s,
        "step_gbuffer_s": ra["stage_s"]["step_gbuffers"] / len(ra["step_s"]),
        "step_probes_s": ra["stage_s"]["step_probes"] / len(ra["step_s"]),
        "subdivided_configure_and_bake_s": ra["stage_s"]["configure_and_bake"],
        "bert_build_s": ra["stage_s"]["bert_build"], "debiasing_s": ra["stage_s"]["debiasing"],
        "build_splitsum_s": res["runs"]["b"]["stage_s"]["build_splitsum"]}
    t = res["timing"]
    log(f"options: warm random-camera step {t['random_step_warm_s']:.4f}s against the fixed "
        f"rig's {t['fixed_step_warm_s'] if fixed_step_s is None else f'{fixed_step_s:.4f}'}s "
        f"(main path 1); per step G-buffer {t['step_gbuffer_s']:.4f}s, probes and table "
        f"{t['step_probes_s']:.4f}s; subdivided configure and bake "
        f"{t['subdivided_configure_and_bake_s']:.3f}s; BERT-base build {t['bert_build_s']:.3f}s, "
        f"debiasing {t['debiasing_s']:.3f}s; build_splitsum for "
        f"{res['runs']['b']['splitsum_shape'][0]} maps {t['build_splitsum_s']:.3f}s")
    res["counts"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                     for k in ("flash_attn_fwd", "ray_cast")}
    del system, dm, ren
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# main path 6: the texcraft family
# ---------------------------------------------------------------------------

UNET_ATTENTIONS = 32        # the UNet's 16 transformer blocks, a self- and a cross-attention each
CONTROLNET_ATTENTIONS = 14  # a ControlNet's 7
TEXCRAFT_CONTROLS = ["depth", "canny", "hed", "normal"]
# replicas of one UNet pass per run: SDS (text, uncond), the triple
# guidance (text, uncond, null), Perp-Neg SDS (text, uncond, two negatives)
TEXCRAFT_BATCH = {"sds": 2, "triple": 3, "perp_neg": 4}
# configs/texcraft.yaml cut to the CPU tiny form (the widths of dreammat_tiny.yaml)
TEXCRAFT_TINY = [
    "system.guidance.model_size=tiny", "system.guidance.half_precision_weights=false",
    "system.guidance.width=32", "system.guidance.height=32",
    "system.prompt_processor.model_size=tiny", "system.init_width=32", "system.init_height=32",
    "system.geometry.pos_encoding_config.n_levels=4",
    "system.geometry.pos_encoding_config.log2_hashmap_size=10",
    "system.geometry.pos_encoding_config.base_resolution=4",
    "system.geometry.pos_encoding_config.per_level_scale=1.5",
    "system.material.env_height=32", "system.material.env_width=64",
    "system.material.diffuse_sample_num=16", "system.material.specular_sample_num=8",
    "data.width=32", "data.height=32", "data.eval_width=32", "data.eval_height=32",
    "data.cond_width=32", "data.cond_height=32",
]


class AttentionBatches:
    """Kernel A's launches by batch size: a context that puts a wrapper in
    the place of ``flash_attention_fwd`` and counts a call by its batch
    where the kernel's wrapper counted a launch. That wrapper counts on its
    module's name, which is this wrapper while the context is open; the
    count goes back to it on exit."""

    def __enter__(self):
        from dreammat_tpu_torch.ops import attention as attn

        self.counts, self._attn = {}, attn
        self._fn = fn = attn.flash_attention_fwd

        def counted(q, k, v):
            before = counted.launches
            out = fn(q, k, v)
            if counted.launches > before:
                self.counts[q.shape[0]] = self.counts.get(q.shape[0], 0) + 1
            return out

        counted.launches = fn.launches
        attn.flash_attention_fwd = counted
        return self

    def __exit__(self, *exc):
        self._fn.launches = self._attn.flash_attention_fwd.launches
        self._attn.flash_attention_fwd = self._fn


def texcraft_argv(work: str, obj: str, device: str, size: str, run: str, steps: int,
                  views: int) -> list:
    """``launch_torch.py --train`` of ``configs/texcraft.yaml`` on ``obj``:
    run ``sds`` (the config's guidance), ``triple`` (the triple guidance
    through a ControlNet per control type of ``TEXCRAFT_CONTROLS``; the
    guidance block is replaced, as the SDS keys do not fit it) or
    ``perp_neg`` (SDS with Perp-Neg); random weights, 1 test view."""
    tiny = size == "tiny"
    argv = ["--config", "configs/texcraft.yaml", "--train", "--device", device,
            f"system.geometry.shape_init=mesh:{obj}", "system.geometry.shape_init_params=1.0",
            "system.prompt_processor.prompt=a ceramic vase",
            "system.prompt_processor.use_cache=false", "system.guidance.cache_dir=null",
            "system.material.environment_texture=/nonexistent", f"data.fix_view_num={views}",
            "data.n_test_views=1", "data.prerender_cache_dir=null",
            f"trainer.max_steps={steps}", f"exp_root_dir={work}/runs_{run}",
            "use_timestamp=false"] + (TEXCRAFT_TINY if tiny else [])
    if run == "triple":
        n = len(TEXCRAFT_CONTROLS)
        g = {"model_size": "tiny" if tiny else "sd21", "half_precision_weights": not tiny,
             "use_controlnet": True, "control_types": TEXCRAFT_CONTROLS,
             "condition_scales": [1.0] * n, "condition_scales_anneal": [1.0] * n,
             "width": 32 if tiny else 512, "height": 32 if tiny else 512, "cache_dir": None,
             "controlnet_path": None, "min_step_percent": 0.02,
             "max_step_percent": [500, 0.98, 0.5, 501]}
        if tiny:
            g["normalbae_detect_resolution"] = 64
        argv += ["system.guidance_type=stable-diffusion-triple-guidance",
                 "system.guidance!=" + json.dumps(g)]
    elif run == "perp_neg":
        argv.append("system.prompt_processor.use_perp_neg=true")
    return argv


def batchnorm_from_input(module, rgb):
    """A copy of a NormalBae whose BatchNorm statistics are those of its
    forward on ``rgb``. With identity statistics (the random weights of a
    run without ``scannet.pt``) the encoder's activations grow from stage
    to stage and its output depends chaotically on rounding (the card's
    fp64 and fp32 forwards differ as much as the card and the CPU), so a
    card-vs-CPU check of it holds nothing; with these it is
    well-conditioned."""
    import copy

    m = copy.deepcopy(module)
    for bn in m.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.reset_running_stats()
            bn.momentum = None
    m.train()
    with torch.no_grad():
        m.detect(rgb)
    return m.eval()


def check_detectors(system, dm) -> dict:
    """HED (edge map and scribble) and NormalBae of the triple guidance on
    one render of view 0, on the card and, from a copy of the same
    modules, on the CPU; their card times. NormalBae is held with its
    BatchNorm statistics taken from the render (``batchnorm_from_input``);
    as the run used it, card and CPU are only reported, beside the card's
    fp64 forward, which shows how far rounding alone moves it. TF32 is as
    the caller set it."""
    import copy

    g = system.guidance
    batch = dm.collate(step=0)
    rgb = torch.clamp(system.render(batch["gbuffer"], batch["env_id"], batch.get("light_table"))
                      ["comp_rgb"], 0, 1).permute(2, 0, 1)[None].contiguous()
    res = {"hw": list(rgb.shape[-2:]), "cudnn_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_tf32": torch.backends.cuda.matmul.allow_tf32}
    for name, module, call in (
            ("hed_edge", g._hed, lambda m, x: m.detect(x)),
            ("hed_scribble", g._hed, lambda m, x: m.detect(x, scribble=True)),
            ("normalbae_as_run", g._normalbae, lambda m, x: m.detect(x)),
            ("normalbae", batchnorm_from_input(g._normalbae, rgb), lambda m, x: m.detect(x))):
        cpu_module = copy.deepcopy(module).cpu()
        with torch.no_grad():
            card = call(module, rgb)
            ms = cuda_ms(lambda: call(module, rgb), 3)
            t0 = time.time()
            cpu = call(cpu_module, rgb.cpu())
            cpu_s = time.time() - t0
        diff = (card.cpu() - cpu).abs()
        res[name] = {"max_abs": diff.max().item(), "share_over_0.5": float((diff > 0.5).float()
                                                                          .mean()),
                     "card_ms": ms, "cpu_s": cpu_s, "mean": float(card.mean())}
        if name == "normalbae_as_run":
            with torch.no_grad():
                card64 = copy.deepcopy(module).double().detect(rgb.double())
            d64 = (card64 - card.double()).abs()
            res[name].update(card_fp64_max_abs=d64.max().item(),
                             card_fp64_share_over_0_5=float((d64 > 0.5).float().mean()))
            del card64
        del cpu_module
    return res


def drive_texcraft(work: str, device: str = "cuda", size: str = "sd21", views: int = 4,
                   steps=(3, 2, 1), torus=(192, 96), playground_size: int = 512,
                   playground_steps: int = 3) -> dict:
    """Main path 6 through ``launch_torch.py --train`` of
    ``configs/texcraft.yaml`` on the torus of main path 3: run ``sds``
    (the config's SDS guidance, ``steps[0]`` steps), ``triple`` (the triple
    guidance with depth, canny, HED and NormalBae ControlNets, ``steps[1]``)
    and ``perp_neg`` (Perp-Neg SDS, ``steps[2]``); ``views`` fixed views, 1
    test view, no export (main path 3 has it). Then the 2D playground
    (``playground_2d_torch.main``). Per run: finite losses, the field
    moved, the test PNG; on the card also kernel A's launches per step
    (32, 32 + 14 per ControlNet, 32) and their batch (2, 3, 4), no
    backward launch, and kernel B in the prerender. The triple run's
    detectors are compared on the card with the CPU. Returns what was
    measured; raises on a failed check."""
    import shutil

    import launch_torch
    import playground_2d_torch
    from dreammat_tpu_torch.data.datamodule import RandomCameraDataModule
    from dreammat_tpu_torch.models import mesh as mesh_lib
    from dreammat_tpu_torch.models.renderer import RaytraceRenderer
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.systems.dreammat import DreamMat

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(work, ignore_errors=True)
    v, f = mesh_lib.torus_arrays(0.7, 0.28, *torus)
    obj = mesh_lib.write_obj(os.path.join(work, "torus.obj"), v, f)
    per_step = {"sds": UNET_ATTENTIONS, "perp_neg": UNET_ATTENTIONS,
                "triple": UNET_ATTENTIONS + len(TEXCRAFT_CONTROLS) * CONTROLNET_ATTENTIONS}
    kernels_a = (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
                 attn.flash_attention_bwd_dkv)
    res = {"runs": {}}
    real_export = DreamMat.export
    DreamMat.export = lambda self, *a, **k: None  # main path 3 has the export
    try:
        for run, n_steps in zip(("sds", "triple", "perp_neg"), steps):
            stages = StageLaunches()
            stages.wrap(RaytraceRenderer, "configure", "configure_and_bake")
            stages.wrap(RaytraceRenderer, "build_gbuffers_batched", "prerender_gbuffers")
            stages.wrap(RandomCameraDataModule, "_fastpath_gate", "gate")
            stages.wrap(RaytraceRenderer, "build_gbuffer", "test_gbuffers")
            for fn in kernels_a + (bvh_lib.cast_rays_dense,):
                fn.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            try:
                with AttentionBatches() as batches:
                    out = launch_torch.main(texcraft_argv(work, obj, device, size, run, n_steps,
                                                          views))
            finally:
                stages.restore()
            sync()
            system, dm, trial = out["system"], out["datamodule"], out["trial_dir"]
            step_s = list(system.step_seconds)
            r = {"seconds": time.time() - t0, "guidance": type(system.guidance).__name__,
                 "launches": {"flash_attn_fwd": attn.flash_attention_fwd.launches,
                              "ray_cast": bvh_lib.cast_rays_dense.launches},
                 "flash_attn_fwd_by_batch": dict(batches.counts),
                 "backward_launches": kernels_a[1].launches + kernels_a[2].launches,
                 "ray_cast_by_stage": dict(stages.counts), "stage_s": dict(stages.seconds),
                 "prerender_s": dict(dm.data.seconds), "step_s": step_s,
                 "warm_step_s": float(np.mean(step_s[1:] or step_s)),
                 "losses": list(system.step_losses), "step_peak_gb": list(system.step_peak_gb),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
            if len(r["losses"]) != n_steps or not all(math.isfinite(x) for x in r["losses"]):
                raise AssertionError(f"path 6 {run}: losses {r['losses']}")
            ref = system.geometry.init(torch.Generator(device=device).manual_seed(
                out["cfg"].seed))
            r["moved"] = max((p.detach() - q.detach()).abs().max().item()
                             for p, q in zip(system.field.parameters(), ref.parameters()))
            if not r["moved"] > 0:
                raise AssertionError(f"path 6 {run}: the field did not move")
            r["test_png"] = check_file(os.path.join(trial, "save", f"it{n_steps}-test", "0.png"),
                                       b"\x89PNG\r\n\x1a\n", 100)
            want = {TEXCRAFT_BATCH[run]: per_step[run] * n_steps}
            if cuda and (r["flash_attn_fwd_by_batch"] != want or r["backward_launches"]
                         or r["launches"]["flash_attn_fwd"] != per_step[run] * n_steps):
                raise AssertionError(f"path 6 {run}: kernel A launches by batch "
                                     f"{r['flash_attn_fwd_by_batch']} (expected {want}), "
                                     f"backward {r['backward_launches']}")
            if cuda and not (stages.counts["configure_and_bake"] > 0
                             and stages.counts["prerender_gbuffers"] > 0):
                raise AssertionError(f"path 6 {run}: kernel B by stage {stages.counts}")
            if run == "triple":
                if not (len(system.guidance.controlnets) == len(TEXCRAFT_CONTROLS)
                        and system.guidance._hed is not None
                        and system.guidance._normalbae is not None):
                    raise AssertionError("the triple guidance lacks a ControlNet or a detector")
                if cuda:
                    d = res["detectors"] = check_detectors(system, dm)
                    nr = d["normalbae_as_run"]
                    log(f"texcraft: detectors on a {d['hw'][0]}^2 render, card vs CPU (cuDNN "
                        f"TF32 {'on' if d['cudnn_tf32'] else 'off'}): "
                        + "; ".join(f"{k} max|diff| {d[k]['max_abs']:.3e}, "
                                    f"{100 * d[k]['share_over_0.5']:.3f}% of values off by "
                                    f"over 0.5, card {d[k]['card_ms']:.3f} ms, CPU "
                                    f"{d[k]['cpu_s']:.2f} s"
                                    for k in ("hed_edge", "hed_scribble", "normalbae",
                                              "normalbae_as_run"))
                        + f" (as run, the card's fp64 forward against its fp32: max|diff| "
                        f"{nr['card_fp64_max_abs']:.3e}, "
                        f"{100 * nr['card_fp64_share_over_0_5']:.3f}% over 0.5)")
                    # edge and normal maps within 1e-3 and one 8-bit level; the
                    # binary scribble map on all but 1% of its values
                    if not (d["hed_edge"]["max_abs"] <= 1e-3
                            and d["normalbae"]["max_abs"] <= 1.0 / 255.0
                            and d["hed_scribble"]["share_over_0.5"] <= 1e-2):
                        raise AssertionError(f"detectors on the card vs the CPU: {d}")
            log(f"texcraft {run} ({r['guidance']}): launch_torch.py --train in "
                f"{r['seconds']:.1f}s; kernel A {r['launches']['flash_attn_fwd']} launches by "
                f"batch {r['flash_attn_fwd_by_batch']}, backward {r['backward_launches']}; "
                f"kernel B {r['launches']['ray_cast']} by stage {r['ray_cast_by_stage']}; "
                f"prerender " + ", ".join(f"{k} {x:.3f}s" for k, x in r["prerender_s"].items())
                + f"; steps {', '.join(f'{x:.4f}s' for x in step_s)} (warm "
                f"{r['warm_step_s']:.4f}s), peak "
                f"{', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])} (run "
                f"{r['peak_gb'] or 0:.2f} GB); losses "
                f"{', '.join(f'{x:.6g}' for x in r['losses'])}; field max |moved| "
                f"{r['moved']:.3e}")
            res["runs"][run] = r
            del out, system, dm
            if cuda:
                torch.cuda.empty_cache()
    finally:
        DreamMat.export = real_export

    for fn in kernels_a:
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with AttentionBatches() as batches:
        pg = playground_2d_torch.main([
            "--prompt", "a ceramic vase", "--model-size", "tiny" if size == "tiny" else "sd21",
            "--size", str(playground_size), "--steps", str(playground_steps),
            "--out", os.path.join(work, "playground"), "--device", device])
    sync()
    p = {"seconds": time.time() - t0, "losses": pg["losses"], "step_s": pg["step_seconds"],
         "warm_step_s": float(np.mean(pg["step_seconds"][1:] or pg["step_seconds"])),
         "flash_attn_fwd_by_batch": dict(batches.counts),
         "backward_launches": kernels_a[1].launches + kernels_a[2].launches,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
         "final_png": check_file(pg["final"], b"\x89PNG\r\n\x1a\n", 100)}
    if len(p["losses"]) != playground_steps or not all(math.isfinite(x) for x in p["losses"]):
        raise AssertionError(f"playground losses {p['losses']}")
    want = {3: UNET_ATTENTIONS * playground_steps}
    if cuda and (p["flash_attn_fwd_by_batch"] != want or p["backward_launches"]):
        raise AssertionError(f"playground: kernel A by batch {p['flash_attn_fwd_by_batch']} "
                             f"(expected {want}), backward {p['backward_launches']}")
    log(f"texcraft playground {playground_size}^2: {playground_steps} steps in "
        f"{p['seconds']:.1f}s (steps {', '.join(f'{x:.4f}s' for x in p['step_s'])}, warm "
        f"{p['warm_step_s']:.4f}s, peak {p['peak_gb'] or 0:.2f} GB); kernel A by batch "
        f"{p['flash_attn_fwd_by_batch']}; losses {', '.join(f'{x:.6g}' for x in p['losses'])}")
    res["playground"] = p
    del pg
    return res


def phase_texcraft() -> dict:
    """Main path 6 on the card (``drive_texcraft`` at SD2.1 width, 512^2)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_texcraft")
    res = drive_texcraft(work)
    runs = res["runs"]
    res["counts"] = {k: sum(r["launches"][k] for r in runs.values())
                     for k in ("flash_attn_fwd", "ray_cast")}
    res["counts"]["flash_attn_fwd"] += sum(res["playground"]["flash_attn_fwd_by_batch"].values())
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the main path")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic training data")
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
    sass = check_sass()
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_res = phase_attention(gen)
    # the texcraft path's batches: SDS (2 replicas) and Perp-Neg SDS (4)
    attn_sds = {B: phase_attention(gen, B) for B in (2, 4)}
    import yaml

    with open(TRAIN_CONFIG) as f:
        batch = yaml.safe_load(f)["train_batch_size"]
    bwd_res = phase_attention_bwd(gen, batch)
    cast_res = phase_ray_cast()
    counts = {"flash_attn_fwd": None, "ray_cast": None}
    cn_counts = {"flash_attn_fwd": None, "flash_attn_bwd_dq": None, "flash_attn_bwd_dkv": None}
    l_counts = {"flash_attn_fwd": None, "ray_cast": None}
    u_counts = {"flash_attn_fwd": None, "ray_cast": None}
    o_counts = {"flash_attn_fwd": None, "ray_cast": None}
    t_counts = {"flash_attn_fwd": None, "ray_cast": None}
    main_res = cn_res = launch_res = user_res = opt_res = tex_res = None
    if not args.kernels_only:
        main_res = phase_main(args.steps, args.views, args.out)
        counts = main_res["counts"]
        cn_res = phase_controlnet(args.steps, batch, args.seed,
                                  os.path.join("outputs", "chip_smoke_controlnet"))
        cn_counts = cn_res["counts"]
        launch_res = phase_launch(args.out, cast_res["clock"])
        l_counts = launch_res["counts"]
        user_res = phase_user_files(cast_res["clock"])
        u_counts = user_res["counts"]
        opt_res = phase_options(cast_res["clock"], main_res["warm_step_s"])
        o_counts = opt_res["counts"]
        tex_res = phase_texcraft()
        t_counts = tex_res["counts"]

    a = max(attn_res["rows"], key=lambda r: r["N"] * r["M"])
    b = max(cast_res["rows"], key=lambda r: r["R"])
    # the backward kernels' largest shape on the ControlNet-training path
    c = max((r for r in bwd_res["rows"] if r["B"] == batch), key=lambda r: r["N"] * r["M"])
    c_work = f"B={c['B']} N={c['N']} M={c['M']} H={c['H']} D={ATTN_D} bf16"
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "dreammat_tpu/ops/attention.py:42",
         "launches": counts["flash_attn_fwd"],
         "launches_by_path": {"dreammat": counts["flash_attn_fwd"],
                              "controlnet_training": cn_counts["flash_attn_fwd"],
                              "dreammat_launch_torus": l_counts["flash_attn_fwd"],
                              "dreammat_user_files": u_counts["flash_attn_fwd"],
                              "dreammat_options": o_counts["flash_attn_fwd"],
                              "texcraft": t_counts["flash_attn_fwd"],
                              "texcraft_by_run_and_batch": tex_res and {
                                  **{run: r["flash_attn_fwd_by_batch"]
                                     for run, r in tex_res["runs"].items()},
                                  "playground": tex_res["playground"]["flash_attn_fwd_by_batch"]}},
         "perp_neg_b5": user_res and {k: user_res["attention_b5"][k] for k in (
             "B", "N", "M", "H", "max_err", "ms", "graph_ms", "plain_ms", "lib_ms",
             "lib_graph_ms", "bound_ms", "by")},
         "sds_batches": {f"b{B}": {"max_abs_err": max(r["max_err"] for r in res["rows"]),
                                   **{k: max(res["rows"], key=lambda r: r["N"] * r["M"])[k]
                                      for k in ("N", "M", "H", "ms", "graph_ms", "host_us",
                                                "plain_ms", "lib_ms", "lib_graph_ms",
                                                "bound_ms", "by")}}
                         for B, res in attn_sds.items()},
         "max_abs_err": max(r["max_err"] for res in (attn_res, *attn_sds.values())
                            for r in res["rows"]),
         "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
         "bound_by": a["by"], "library_ms": a["lib_ms"], "graph_ms": a["graph_ms"],
         "host_us": a["host_us"], "library_graph_ms": a["lib_graph_ms"],
         "library_host_us": a["lib_host_us"], "sass": sass["flash_attn_fwd"],
         "work": f"B={ATTN_B} N={a['N']} M={a['M']} H={a['H']} D={ATTN_D} bf16"},
        {"name": "flash_attn_bwd_dq", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "dreammat_tpu/ops/attention.py:115",
         "launches": cn_counts["flash_attn_bwd_dq"],
         "max_abs_err": max(r["errs"]["dq"]["max"] for r in bwd_res["rows"]),
         "ms": c["dq_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["dq_bound_ms"],
         "bound_by": c["dq_by"], "library_ms": c["lib_dq_ms"], "graph_ms": c["dq_graph_ms"],
         "host_us": c["dq_host_us"], "library_graph_ms": c["lib_dq_graph_ms"],
         "library_host_us": c["lib_dq_host_us"], "sass": sass["flash_attn_bwd_dq"],
         "work": c_work + "; plain_ms computes dq, dk and dv; library: autograd of SDPA wrt q"},
        {"name": "flash_attn_bwd_dkv", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "dreammat_tpu/ops/attention.py:146",
         "launches": cn_counts["flash_attn_bwd_dkv"],
         "max_abs_err": max(max(r["errs"]["dk"]["max"], r["errs"]["dv"]["max"])
                            for r in bwd_res["rows"]),
         "ms": c["dkv_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["dkv_bound_ms"],
         "bound_by": c["dkv_by"], "library_ms": c["lib_dkv_ms"], "graph_ms": c["dkv_graph_ms"],
         "host_us": c["dkv_host_us"], "library_graph_ms": c["lib_dkv_graph_ms"],
         "library_host_us": c["lib_dkv_host_us"], "sass": sass["flash_attn_bwd_dkv"],
         "work": c_work + "; plain_ms computes dq, dk and dv; library: autograd of SDPA wrt k, v"},
        {"name": "ray_cast", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/ray_cast.cu",
         "replaces": "dreammat_tpu/ops/bvh.py:579",
         "launches": counts["ray_cast"],
         "launches_by_path": {"dreammat": counts["ray_cast"],
                              "dreammat_launch_torus": l_counts["ray_cast"],
                              "dreammat_launch_torus_by_stage":
                                  launch_res and launch_res["stage_launches"],
                              "dreammat_user_files": u_counts["ray_cast"],
                              "dreammat_options": o_counts["ray_cast"],
                              "dreammat_options_by_stage": opt_res and {
                                  run: r["ray_cast_by_stage"]
                                  for run, r in opt_res["runs"].items()},
                              "texcraft": t_counts["ray_cast"],
                              "texcraft_by_stage": tex_res and {
                                  run: r["ray_cast_by_stage"]
                                  for run, r in tex_res["runs"].items()}},
         "traffic": [{k: r[k] for k in ("label", "R", "T", "checked", "pairs", "ms", "bound_ms",
                                        "by", "bound_all_pairs_ms", "flips", "face_diff")}
                     for r in ((launch_res["ray_cast"] if launch_res else [])
                               + ([user_res["ray_cast_view"]] if user_res else [])
                               + ([opt_res["ray_cast_sampled_view"]] if opt_res else []))],
         "max_abs_err": max(r["t_err"] for r in cast_res["rows"]),
         "sm_clock_mhz": b["sm_clock_mhz"],
         "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
         "bound_by": b["by"], "library_ms": None,
         "work": f"R={b['R']} rays x T={b['T']} triangles fp32, {b['pairs']:.4g} pairs "
                 f"tested after the cull; bound over all pairs {b['bound_all_pairs_ms']:.4g} ms"},
    ]
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump({"attention": attn_res, "attention_sds": attn_sds, "texcraft": tex_res,
                   "attention_bwd": bwd_res, "ray_cast": cast_res, "sass": sass,
                   "kernels": kernels, "main": main_res, "controlnet": cn_res,
                   "launch": launch_res, "user_files": user_res, "options": opt_res,
                   "card": card}, f, indent=1,
                  default=str)
    log(f"total {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
