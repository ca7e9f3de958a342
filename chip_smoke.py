"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                 # everything, twelve to sixteen minutes
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
   with Perp-Neg; then the volume path's shapes, main path 7): max and mean
   error of O, max error of the log-sum-exp, the
   kernel's time (CUDA events over many launches; device time from a
   CUDA-graph replay of 20 launches; host microseconds per launch), the
   plain version's, the bound, and
   ``torch.nn.functional.scaled_dot_product_attention``'s, timed the same
   ways, as a yardstick.
4. Kernels C and D (flash-attention backward, dq and dk/dv) against
   ``attention_backward_plain`` at every attention shape of ControlNet
   training (SD2.1 width, 32^2 latents, the training batch), at B=3,
   N=M=4096 and at B = 1 at the volume path's shapes (main path 7): max and
   mean error and cosine of dq, dk, dv, each kernel's
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
   99% of its values, card against the same module on the CPU) and
   NormalBae (with its BatchNorm statistics taken from the render: as the
   run uses it, with random weights and identity statistics, its output
   depends chaotically on rounding, which the card's fp64 forward shows;
   the card's fp32 forward and the CPU's each within one 8-bit level of
   the CPU's fp64 forward, card against CPU reported) on a 512^2 render,
   with their card times.
   Each run's seconds, warm step and peak memory are printed. The same
   runs go on the CPU at tiny size with ``drive_texcraft(work,
   device="cpu", size="tiny", torus=(24, 12), playground_size=32)``.
12. Main path 7: the NeRF-volume family (``drive_volume``), through
   ``launch_torch.main(["--config", "configs/dreamfusion.yaml", "--train",
   ...])`` (SDS over a NeRF volume at 64^2, as written) and the same with
   ``configs/prolificdreamer.yaml`` (the VSD coarse stage; its background
   block replaced, its ``random_aug`` does not parse; 128^2 renders, cut
   from 512^2: the dense renderer's 512 samples a ray and the hash grid's
   backward state would take about 430 GB) at SD2.1 width, random weights,
   3 steps with the occupancy refresh every 2 steps, 1 test view, the
   isosurface export at level ``VOLUME_ISO_LEVEL``. Per run: finite losses,
   the test PNG, the gif and ``model.obj`` with vertices and faces, the
   grid refreshed at init and at steps 0 and 2; ProlificDreamer's LoRA
   factors and camera embedding moved and its frozen UNet unchanged (per
   tensor checksums); kernel A by batch, C and D exactly as
   ``VOLUME_PER_STEP`` says (SDS 32 at B = 2 a step; VSD 64 at B = 2 and
   32 at B = 1, C 32 and D 32: the LoRA regression backpropagates through
   the whole UNet); 2048 rays of eval view 0 rendered by the trained scene
   on the card and on the CPU within 2e-3. The kernel phase checks A at B = 2 and 1 and C and D at
   B = 1 at every attention shape of 16^2 and 8^2 latents
   (``VOLUME_ATTN_SHAPES``: N down to 1, self and N x 77). Each run's
   seconds, warm step, peak memory and test-view seconds are printed. The
   same runs go on the CPU at tiny size with ``drive_volume(work,
   device="cpu", size="tiny")``.
13. Main path 8: the DMTet family (``drive_dmtet``), five
   ``launch_torch.main(["--config", ..., "--train", ...])`` runs under
   ``outputs/chip_smoke_dmtet/`` at SD2.1 width, random weights, 512^2
   renders, DMTet ``isosurface_resolution`` 128 (2,146,689 lattice vertices,
   12,582,912 tets) with the default budget of 2^17 crossing tets (262,144
   triangle slots), 1 test view (``DMTET_RUNS``): Fantasia3D's geometry
   stage (``configs/fantasia3d.yaml`` as written, 3 steps with
   ``latent_steps=2``: the latent branch twice, then the VAE branch; its
   ``model.obj``), its texture stage (``pbr-material`` with 8 feature
   channels on the procedural sky, 2 steps), Magic3D's refinement
   (``configs/dreamfusion.yaml`` with ``magic3d-system``, ``refinement`` and
   the geometry, renderer, material and background blocks replaced, 2
   steps) and ProlificDreamer's geometry and texture stages
   (``configs/prolificdreamer.yaml`` under VSD with the geometry, renderer
   and background blocks replaced, 2 steps each). Per run: finite losses,
   the SDF moved (geometry stages) or unchanged by checksum with the
   feature MLP moved (texture stages), the test PNG; kernel B exactly one
   launch per training step (the rasterizer's hit pass) and one per eval
   chunk; kernel A by batch and C and D as ``VOLUME_PER_STEP`` says for the
   guidance; the kernel phase checks A, C and D at B = 1 at every
   attention shape of 64^2 latents (``ATTN_SHAPES``; the VSD runs' LoRA
   regression), A at B = 2 there being the SDS check's. Then kernel B bit
   for bit against ``cast_rays_plain`` on
   65,536 of the last step's rays against its whole soup (16,384 after
   the first run) and on 4096 rays through the origin (none may report an
   invalid slot), with its time, pairs tested and bound; the step's parts
   (marching tets, vertex normals, the hit pass, the SDF opacity and the
   whole render, forward and backward; the first run's render also by
   kernel through ``torch.profiler``); the mesh part of a step (the
   isosurface, the hit pass, the render, the mesh losses and the backward)
   under ``torch.cuda.set_sync_debug_mode("warn")``, where no operation may
   synchronize with the host; for Fantasia3D's geometry stage
   2048 rays of eval view 0 on the card and on the CPU (at most 1e-3 of
   the hits differ, 2e-3 where they agree). Each run's seconds, warm step and peak memory are printed. The
   same runs go on the CPU at tiny size with ``drive_dmtet(work,
   device="cpu", size="tiny")``.
14. Main path 9: the rest of the volume family (``drive_volume_rest``),
   four ``launch_torch.main(["--config", ..., "--train", ...])`` runs under
   ``outputs/chip_smoke_volume_rest/`` at SD2.1 width, random weights, 3
   steps with the occupancy refresh every 2, 1 test view
   (``VOLUME_REST_RUNS``): Latent-NeRF (``configs/sjc_tiny.yaml`` with
   ``latentnerf-system`` and the guidance, prompt, geometry and renderer
   blocks replaced: an ``implicit-volume`` at the JAX defaults with 4
   latent channels, 512^2 renders through the ``patch-renderer``, a 128^2
   patch and a 128^2 strided global pass of 512 samples a ray, the torus of
   main path 3 as guide shape baked at 64^3, eval at 64^2 decoded to
   512^2), its refinement (RGB through ``sd-latent-adapter-material`` and
   the VAE encode, eval at 512^2), SJC (the same renders of a 100^3
   ``volume-grid`` over a 64 x 64 ``textured-background``) and TextMesh
   (``configs/textmesh.yaml``, NeuS over ``implicit-sdf``, cut to 64^2).
   Per run: finite losses and parameters, the field moved (checksums) and
   TextMesh's NeuS variance, the grid refreshed at init and at steps 0 and
   2, the test PNG and ``model.obj`` (level 5, the grid's 1, the SDF's 0);
   kernel A exactly 32 launches a step at B = 2, C, D and B none; the
   guide's winding grid on the card against the CPU at 2048 voxels (at
   most 1e-3 flip inside/outside); 2048 rays of eval view 0 on the card
   and on the CPU within 2e-3. Each run's seconds, warm step, peak memory
   and test-view seconds are printed. The same runs go on the CPU at tiny
   size with ``drive_volume_rest(work, device="cpu", size="tiny")``.
15. Main path 10: the single-image family and DeepFloyd IF
   (``drive_single_image``): the input image is made first, the torus of
   main path 3 turned to face Zero123's reference camera and cast through
   kernel B at 512^2 (RGBA, ``_depth.png``, ``_normal.png``); then eight
   ``launch_torch.main(["--config", ..., "--train", ...])`` runs of
   ``SINGLE_IMAGE_RUNS`` under ``outputs/chip_smoke_single_image/`` at full
   width, random weights in bf16, 3 steps, 1 test view: Zero123
   (``configs/zero123.yaml``, accumulate mode, the depth and normal side
   files on, renders cut from 128^2, which runs out of memory, to
   ``SINGLE_IMAGE_RES`` = 64^2), its simple
   system, image-conditioned DreamFusion (the SD2.1 guidance, 64^2),
   Zero123's refinement (DMTet 128, the rasterizer, 512^2), Magic123's
   volume stage (SD2.1 and Zero123 on one view, 64^2) and its refinement
   (512^2), DreamFusion-IF (``configs/dreamfusion.yaml`` with
   ``deep-floyd-guidance`` and the T5-XXL prompt processor) without and
   with Perp-Neg; then the ``zero123-vsd-guidance`` phase (3 AdamW steps of
   the LoRA state on ``loss_lora`` plus ``loss_vsd``'s image gradient).
   Per run: finite losses and parameters, the test PNG and ``model.obj``;
   kernel A by batch exactly ``SINGLE_IMAGE_RUNS`` says, C and D none,
   kernel B one a refinement step and one an eval chunk, none elsewhere;
   the VSD phase kernel A 64 at B = 2 and 32 at B = 1, C 32 and D 32 a
   step, the LoRA factors and camera embedding moved and the frozen UNet
   not (checksums); for Zero123 2048 eval rays card against CPU within
   2e-3 and the CLIP token and ``c_concat`` card against CPU in fp32
   within 1e-3. The kernel phase also checks A at B = 2 and 1 and C and D
   at B = 1 at the Zero123 UNet's shapes (``ZERO123_ATTN_SHAPES``: 32^2
   latents, cross-attention to one token, M = 1). Each run's first and
   warm step, peak memory and test-view seconds are printed. The same runs
   go on the CPU at tiny size with ``drive_single_image(work,
   device="cpu", size="tiny")``.
16. Main path 11: the editing family, Instruct-NeRF2NeRF and Control4D
   (``drive_edit``): the capture is made first, the torus of main path 3
   cast through kernel B at 256^2 from 24 cameras on a ring, written as a
   nerfstudio ``transforms.json`` capture and as one CO3D sequence
   (``frame_annotations.jgz``, 16-bit depth PNGs, masks); then two
   ``launch_torch.main(["--config", "configs/dreamfusion.yaml", "--train",
   ...])`` runs of ``EDIT_RUNS`` under ``outputs/chip_smoke_edit/`` with the
   InstructPix2Pix guidance at full width in bf16 (512^2 edits, 64^2
   latents, 20 DDIM steps) and its 768-wide text tower, random weights:
   Instruct-NeRF2NeRF on the multiview capture at 64^2 (cut from 256^2 for
   memory), 3 steps, an edit at steps 1 and 2; Control4D on the CO3D
   sequence at 256^2 through the GAN renderer at the JAX defaults, 6
   steps, an edit every step; then the ``ip2p-sds`` phase (3 AdamW steps
   of a 512^2 image under ``use_sds``). Per run: finite losses and
   parameters, the field and the networks moved (checksums), the frames
   edited, the test PNG, Control4D's generator levels (0, 1 and 2 each at
   least once); kernel A exactly 640 launches at B = 3 an edit and 32 an
   SDS step, nothing at another batch, C, D and B none in the runs; 2048
   eval rays card against CPU within 2e-3, the perceptual distance of a
   frame and its edit in fp32 within 1e-4 relative and the first DDIM
   step's guided eps at full width in fp32 within 1e-3. Each run's first
   and warm step, edit seconds, peak memory and test-view seconds are
   printed. The same runs go on the CPU at tiny size with
   ``drive_edit(work, device="cpu", size="tiny")``.
17. Main path 12: more than one process (``drive_parallel``), under
   ``outputs/chip_smoke_parallel/``. First torchrun's variables set in this
   process for a world of one: ``train_controlnet.main`` joins an NCCL
   group (asserted) and trains 3 steps at batch 32, the ControlNet in
   ``DistributedDataParallel``, whose gradient all-reduces the trainer's
   comm hook counts (none would be reported and an explicit all-reduce and
   barrier run instead); kernels A, C and D exactly as path 2, the losses
   within ``PARALLEL_LOSS_RTOL`` of path 2's. Then two ranks spawned on the
   one card over gloo (NCCL refuses two ranks on one device;
   ``parallel_rank``): the SD2.1 UNet split over both by
   ``tp_shard_params`` (bf16, B = 3, 64^2 latents) no further from the
   replicated bf16 output than three times that output's own distance
   from the fp32 forward, kernel A by local heads {5: 20, 10: 12} a rank;
   DDP training at global batch 32 (16 a rank) for 2 steps, its losses
   within ``PARALLEL_LOSS_RTOL`` of the world-1 run's and its ControlNet's
   movement at cosine 0.99 or more of the world-1 run's checkpoint at step
   2, equal on both ranks, kernels A, C and D per rank as path 2 a step;
   ``shard_rays`` of a DreamMat eval view within 1e-6 of the local render;
   ``rank_zero_fill`` running its fill once. Last
   ``batch_generate_torch.py --shard 0/2`` and ``1/2`` as two processes at
   once over two DreamMat jobs on the torus (2 steps, 4 views, 1 test view,
   the export at 256^2): each job once, in its shard, with its files. The
   same runs go on the CPU at tiny size with ``drive_parallel(work,
   device="cpu", size="tiny", torus=(24, 12))``.
18. A ``{"kernels": [...]}`` line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Longer logs go to ``outputs/chip_smoke/`` (``--out``). fp32 comparisons run with
TF32 off (``allow_tf32 = False`` for matmuls and cuDNN).
"""

from __future__ import annotations

import argparse
import contextlib
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


def phase_attention(gen: torch.Generator, B: int = ATTN_B, shapes=ATTN_SHAPES) -> dict:
    import torch.nn.functional as F

    from dreammat_tpu_torch.ops import attention as attn

    D = ATTN_D
    rows = []
    for N, M, H in shapes:
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


def phase_attention_bwd(gen: torch.Generator, batch: int, cases=None,
                        autograd_check: bool = True) -> dict:
    """Kernels C and D against the plain backward (fp32 FlashAttention-2
    equations) at the training shapes (or the (B, N, M, H) ``cases``);
    tolerance cosine >= 0.999 and max error <= 2e-2 max|ref| for each of dq,
    dk, dv (the kernels round p and ds to bf16 before their products, as the
    TPU kernels do)."""
    import torch.nn.functional as F

    from dreammat_tpu_torch.ops import attention as attn

    D = ATTN_D
    if cases is None:
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
            if M == 1 and name != "dv":
                # one key: the softmax is constant, so ds = p (dO.v - D) and
                # with it dq and dk are exactly zero; both sides hold only the
                # fp32 rounding of dO.v - D (~1e-6), and a cosine of two
                # rounding noises says nothing
                ok = errs[name]["max"] <= 1e-4
            else:
                ok = errs[name]["cos"] >= 0.999 and \
                    errs[name]["max"] <= 2e-2 * errs[name]["ref_max"]
            if not ok:
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
    if not autograd_check:
        return {"rows": rows}

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
    write_controlnet_dataset(data_dir, seed)
    log(f"controlnet: synthetic dataset (1 object, 16 views x 5 envs, 256^2, f16) written in "
        f"{time.time() - t0:.1f}s")
    argv = controlnet_argv(work_dir, "sd21", steps, seed, "run")
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


def _cast_case(label, bvh, tri, o, d, clock, check_idx=None, chunk: int = 2048):
    """Kernel B on the rays (o, d): its time, the pairs it tested, its
    bound, and the plain caster (``chunk`` rays at a time) on ``check_idx``
    (all rays if None), which must agree bit for bit."""
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    R, T = o.shape[0], tri[0].shape[1]
    pairs_t = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri, pairs_out=pairs_t)
    ms = cuda_ms(lambda: bvh_lib.cast_rays_dense(bvh, o, d, tri_data=tri), 3)
    sel = torch.arange(R, device="cuda") if check_idx is None else check_idx
    os_, ds = o[sel].contiguous(), d[sel].contiguous()
    t0 = time.time()
    ref = bvh_lib.cast_rays_plain(bvh, os_, ds, chunk=chunk, tri_data=tri)
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
    """Kernel A's launches by batch size (by ``q.shape[axis]``: ``axis=2``
    counts by heads): a context that puts a wrapper in the place of
    ``flash_attention_fwd`` and counts a call where the kernel's wrapper
    counted a launch. That wrapper counts on its module's name, which is
    this wrapper while the context is open; the count goes back to it on
    exit."""

    def __init__(self, axis: int = 0):
        self.axis = axis

    def __enter__(self):
        from dreammat_tpu_torch.ops import attention as attn

        self.counts, self._attn = {}, attn
        self._fn = fn = attn.flash_attention_fwd

        def counted(q, k, v):
            before = counted.launches
            out = fn(q, k, v)
            if counted.launches > before:
                key = q.shape[self.axis]
                self.counts[key] = self.counts.get(key, 0) + 1
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
    BatchNorm statistics taken from the render (``batchnorm_from_input``),
    the card's fp32 forward and the CPU's each against the fp64 forward of
    the same module on the CPU (fp32 rounding alone moves either by up to
    3.3e-3 from it, ``tools/normalbae_rounding.py``, so card against CPU
    can differ by twice that); as the run used it, card and CPU are only
    reported, beside the card's fp64 forward, which shows how far rounding
    alone moves it. TF32 is as the caller set it."""
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
        if name == "normalbae":
            with torch.no_grad():
                ref64 = copy.deepcopy(cpu_module).double().detect(rgb.cpu().double())
            res[name].update(card_vs_fp64=(card.cpu().double() - ref64).abs().max().item(),
                             cpu_vs_fp64=(cpu.double() - ref64).abs().max().item())
            del ref64
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
                        f"{100 * nr['card_fp64_share_over_0_5']:.3f}% over 0.5); NormalBae "
                        f"against the CPU's fp64 forward: card "
                        f"{d['normalbae']['card_vs_fp64']:.3e}, CPU "
                        f"{d['normalbae']['cpu_vs_fp64']:.3e}")
                    # the edge map within 1e-3 card against CPU; the normal map of
                    # card and CPU each within one 8-bit level of fp64; the binary
                    # scribble map on all but 1% of its values
                    if not (d["hed_edge"]["max_abs"] <= 1e-3
                            and d["normalbae"]["card_vs_fp64"] <= 1.0 / 255.0
                            and d["normalbae"]["cpu_vs_fp64"] <= 1.0 / 255.0
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


# ---------------------------------------------------------------------------
# main path 7: the NeRF-volume family
# ---------------------------------------------------------------------------

# (N, M, H) of every D=64 attention of the SD2.1 UNet on the volume path:
# 16^2 latents (ProlificDreamer's 128^2 renders) and 8^2 latents
# (DreamFusion's 64^2): self-attention at each down level with attention and
# the mid block, and cross-attention to the 77 text tokens at each
VOLUME_ATTN_SHAPES = {
    "latent16": [(256, 256, 5), (64, 64, 10), (16, 16, 20), (4, 4, 20),
                 (256, 77, 5), (64, 77, 10), (16, 77, 20), (4, 77, 20)],
    "latent8": [(64, 64, 5), (16, 16, 10), (4, 4, 20), (1, 1, 20),
                (64, 77, 5), (16, 77, 10), (4, 77, 20), (1, 77, 20)],
}
VOLUME_RUNS = ("dreamfusion", "prolificdreamer")
# kernel launches per step: SDS, two replicas (text, uncond); VSD, the
# pretrained CFG pass (B = 2), the LoRA branch's camera CFG pass (B = 2) and
# the regression (B = 1) with its backward, which needs dq, dk and dv at
# every attention (LoRA on to_q, to_k and to_v of both attentions)
VOLUME_PER_STEP = {
    "dreamfusion": {"fwd_by_batch": {2: UNET_ATTENTIONS}, "dq": 0, "dkv": 0},
    "prolificdreamer": {"fwd_by_batch": {2: 2 * UNET_ATTENTIONS, 1: UNET_ATTENTIONS},
                        "dq": UNET_ATTENTIONS, "dkv": UNET_ATTENTIONS},
}
# the isosurface level of the export: a field 3 steps from its blob
# (density 10 at the centre, falling to 0 at radius 0.5) has no level at the
# configs' 25, so the smoke runs extract the level 5
VOLUME_ISO_LEVEL = 5.0
# the configs cut to the CPU tiny form
VOLUME_TINY = [
    "system.guidance.model_size=tiny", "system.guidance.half_precision_weights=false",
    "system.guidance.width=24", "system.guidance.height=24",
    "system.prompt_processor.model_size=tiny",
    "system.geometry.pos_encoding_config.n_levels=4",
    "system.geometry.pos_encoding_config.log2_hashmap_size=10",
    "system.geometry.pos_encoding_config.base_resolution=4",
    "system.geometry.pos_encoding_config.per_level_scale=1.5",
    "system.geometry.isosurface_resolution=24", "system.renderer.num_samples_per_ray=32",
    "system.renderer.grid_resolution=8", "system.renderer.eval_chunk_rays=256",
    "data.width=24", "data.height=24", "data.eval_width=24", "data.eval_height=24",
]


def volume_argv(work: str, device: str, size: str, run: str, steps: int) -> list:
    """``launch_torch.py --train`` of ``configs/{run}.yaml`` with
    ``volume_overrides``."""
    return (["--config", f"configs/{run}.yaml", "--train", "--device", device]
            + volume_overrides(work, size, run, steps))


def volume_overrides(work: str, size: str, run: str, steps: int) -> list:
    """Random weights, ``steps`` steps with the occupancy refresh every 2,
    1 test view, the export at ``VOLUME_ISO_LEVEL``. ProlificDreamer's
    background block is replaced (its ``random_aug`` does not parse) and
    its renders cut from 512^2 to 128^2 (16^2 latents): the dense renderer
    takes all 512 samples of every ray, and the hash grid's backward keeps
    about 3.2 KB per sample, 430 GB at 512^2."""
    tiny = size == "tiny"
    argv = ["system.prompt_processor.prompt=a ceramic vase",
            "system.prompt_processor.use_cache=false", "system.guidance.cache_dir=null",
            "system.renderer.grid_update_every=2",
            f"system.geometry.isosurface_threshold={VOLUME_ISO_LEVEL}", "data.n_test_views=1",
            f"trainer.max_steps={steps}", "trainer.val_check_interval=0",
            "checkpoint.every_n_train_steps=0", f"exp_root_dir={work}/runs_{run}",
            "use_timestamp=false"]
    if run == "prolificdreamer":
        argv.append("system.background!={color_activation: sigmoid}")
        if not tiny:
            argv += ["data.width=128", "data.height=128"]
    return argv + (VOLUME_TINY if tiny else [])


def volume_render_vs_cpu(system, dm, cfg, n_rays: int = 2048) -> dict:
    """``n_rays`` rays of eval view 0 (evenly spaced over the image)
    rendered by the trained scene on the card and, from a copy of it, by
    the same system built on the CPU: max |diff| of the composited colour
    and opacity and the relative max |diff| of the depth. Tolerance 2e-3:
    the finite-difference normals divide fp32 density differences by 0.01,
    and the samples run through the same occupancy grid (a copy) on both.
    NeuS renders with the scene's variance; the CPU system is built without
    a guide shape (its bake plays no part in a render)."""
    import copy

    import dreammat_tpu_torch

    batch = dm.eval_rays(0)
    ro, rd = batch["rays_o"].reshape(-1, 3), batch["rays_d"].reshape(-1, 3)
    idx = torch.linspace(0, ro.shape[0] - 1, n_rays, device=ro.device).long()
    ro, rd = ro[idx], rd[idx]
    lp = batch["light_position"].reshape(1, 3).expand_as(ro)
    cpu_cfg = {**cfg.system, "guide_shape": None} if "guide_shape" in cfg.system else cfg.system
    cpu_sys = dreammat_tpu_torch.find(cfg.system_type)(cpu_cfg, device="cpu")
    field = copy.deepcopy(system.field).cpu()
    step = system.global_step
    kw = lambda f: {"var": f.var} if hasattr(f, "var") else {}
    with torch.no_grad():
        card = system.renderer.render_rays(system.field.geo, system.field.bg, system.field.occ,
                                           ro, rd, lp, None, step=step, **kw(system.field))
        cpu = cpu_sys.renderer.render_rays(field.geo, field.bg, field.occ, ro.cpu(), rd.cpu(),
                                           lp.cpu(), None, step=step, **kw(field))
    res = {"rays": n_rays, "hit_share": float((cpu["opacity"] > 0.5).float().mean())}
    for key in ("comp_rgb", "opacity", "depth"):
        diff = (card[key].cpu() - cpu[key]).abs().max().item()
        res[key] = diff / max(cpu[key].abs().max().item(), 1e-6) if key == "depth" else diff
    if not max(res["comp_rgb"], res["opacity"], res["depth"]) <= 2e-3:
        raise AssertionError(f"volume render, card against the CPU: {res}")
    return res


def drive_volume(work: str, device: str = "cuda", size: str = "sd21", steps: int = 3) -> dict:
    """Main path 7 through ``launch_torch.py --train`` of
    ``configs/dreamfusion.yaml`` (SDS over a NeRF volume, 64^2 renders, as
    written) and ``configs/prolificdreamer.yaml`` (the VSD coarse stage,
    128^2 renders) at SD2.1 width with random weights: ``steps`` steps each
    (the occupancy refresh at steps 0 and 2), 1 test view, the isosurface
    export. Per run: finite losses; the test PNG, the gif and ``model.obj``
    with vertices and faces; the occupancy grid refreshed at init and every
    2 steps; for ProlificDreamer the LoRA state moved from its init and the
    frozen UNet did not (per-tensor checksums). On the card also kernel A's
    launches per step by batch and kernels C's and D's (``VOLUME_PER_STEP``).
    Returns each run's seconds, steps, peak memory, launches and losses;
    raises on a failed check."""
    import shutil

    import launch_torch
    from dreammat_tpu_torch.models.volume_renderer import NeRFVolumeRenderer
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.systems.prolificdreamer import ProlificDreamer

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(work, ignore_errors=True)
    kernels_a = (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
                 attn.flash_attention_bwd_dkv)
    res = {"runs": {}}
    for run in VOLUME_RUNS:
        refreshes, unet_sums = [], {}
        real_update, real_start = NeRFVolumeRenderer.update_occ, ProlificDreamer.on_fit_start

        def update_occ(self, *a, **k):
            refreshes.append(1)
            return real_update(self, *a, **k)

        def on_fit_start(self, *a, **k):
            real_start(self, *a, **k)
            if not unet_sums:
                unet_sums.update({n: tensor_checksum(p)
                                  for n, p in self.guidance.unet.named_parameters()})

        NeRFVolumeRenderer.update_occ, ProlificDreamer.on_fit_start = update_occ, on_fit_start
        for fn in kernels_a:
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            with AttentionBatches() as batches:
                out = launch_torch.main(volume_argv(work, device, size, run, steps))
        finally:
            NeRFVolumeRenderer.update_occ, ProlificDreamer.on_fit_start = real_update, real_start
        sync()
        system, trial = out["system"], out["trial_dir"]
        step_s = list(system.step_seconds)
        r = {"seconds": time.time() - t0, "system": type(system).__name__,
             "guidance": type(system.guidance).__name__,
             "render_hw": [out["datamodule"].cfg.height, out["datamodule"].cfg.width],
             "launches": {"flash_attn_fwd": kernels_a[0].launches,
                          "flash_attn_bwd_dq": kernels_a[1].launches,
                          "flash_attn_bwd_dkv": kernels_a[2].launches},
             "flash_attn_fwd_by_batch": dict(batches.counts), "occ_refreshes": len(refreshes),
             "step_s": step_s, "warm_step_s": float(np.mean(step_s[1:] or step_s)),
             "test_s": list(system.test_seconds), "losses": list(system.step_losses),
             "step_peak_gb": list(system.step_peak_gb),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"path 7 {run}: losses {r['losses']}")
        # the grid refreshed by init_state and at every second step
        if r["occ_refreshes"] != 1 + len(range(0, steps, 2)):
            raise AssertionError(f"path 7 {run}: {r['occ_refreshes']} occupancy refreshes")
        save = os.path.join(trial, "save")
        r["test_png"] = check_file(os.path.join(save, f"it{steps}-test", "0.png"),
                                   b"\x89PNG\r\n\x1a\n", 100)
        r["gif"] = check_file(os.path.join(save, f"it{steps}-test.gif"), b"GIF8", 100)
        with open(os.path.join(save, "export", "model.obj")) as f:
            lines = f.read().splitlines()
        r["obj_v"] = sum(ln.startswith("v ") for ln in lines)
        r["obj_f"] = sum(ln.startswith("f ") for ln in lines)
        if not (r["obj_v"] > 0 and r["obj_f"] > 0):
            raise AssertionError(f"path 7 {run}: model.obj has {r['obj_v']} v, {r['obj_f']} f")
        if run == "prolificdreamer":
            ref = system.guidance.init_lora(torch.Generator(device=device).manual_seed(
                out["cfg"].seed + 0x70AA))
            moved = {n: (p.detach() - q.detach()).abs().max().item()
                     for (n, p), q in zip(system.lora.named_parameters(), ref.parameters())}
            r["lora_moved"] = {"up": max(v for n, v in moved.items() if n.endswith(".up")),
                               "down": max(v for n, v in moved.items() if n.endswith(".down")),
                               "camera_embedding": max(v for n, v in moved.items()
                                                       if n.startswith("camera_embedding"))}
            r["lora_params"] = sum(p.numel() for p in system.lora.parameters())
            r["unet_changed"] = sum(tensor_checksum(p) != unet_sums[n]
                                    for n, p in system.guidance.unet.named_parameters())
            if not (min(r["lora_moved"].values()) > 0 and r["unet_changed"] == 0):
                raise AssertionError(f"path 7 {run}: LoRA moved {r['lora_moved']}, frozen UNet "
                                     f"tensors changed {r['unet_changed']}")
            del ref
        if cuda:
            r["render_vs_cpu"] = volume_render_vs_cpu(system, out["datamodule"], out["cfg"])
        want = VOLUME_PER_STEP[run]
        want_fwd = {b: n * steps for b, n in want["fwd_by_batch"].items()}
        if cuda and (r["flash_attn_fwd_by_batch"] != want_fwd
                     or r["launches"]["flash_attn_bwd_dq"] != want["dq"] * steps
                     or r["launches"]["flash_attn_bwd_dkv"] != want["dkv"] * steps):
            raise AssertionError(f"path 7 {run}: kernel A by batch {r['flash_attn_fwd_by_batch']}"
                                 f" (expected {want_fwd}), C and D {r['launches']} (expected "
                                 f"{want['dq'] * steps} and {want['dkv'] * steps})")
        log(f"volume {run} ({r['guidance']}, {r['render_hw'][0]}^2 renders): launch_torch.py "
            f"--train in {r['seconds']:.1f}s; kernel A by batch {r['flash_attn_fwd_by_batch']}, "
            f"C {r['launches']['flash_attn_bwd_dq']}, D {r['launches']['flash_attn_bwd_dkv']}; "
            f"occupancy refreshes {r['occ_refreshes']}; steps "
            f"{', '.join(f'{x:.4f}s' for x in step_s)} (warm {r['warm_step_s']:.4f}s), peak "
            f"{', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])} (run {r['peak_gb'] or 0:.2f}"
            f" GB); test view {', '.join(f'{x:.3f}s' for x in r['test_s'])}; model.obj "
            f"{r['obj_v']} v, {r['obj_f']} f; losses {', '.join(f'{x:.6g}' for x in r['losses'])}"
            + (f"; LoRA ({r['lora_params']} params) moved {r['lora_moved']}, frozen UNet tensors "
               f"changed {r['unet_changed']}" if "lora_moved" in r else "")
            + (f"; {r['render_vs_cpu']['rays']} eval rays card vs CPU: comp_rgb "
               f"{r['render_vs_cpu']['comp_rgb']:.2e}, opacity {r['render_vs_cpu']['opacity']:.2e}"
               f", depth (relative) {r['render_vs_cpu']['depth']:.2e} ("
               f"{100 * r['render_vs_cpu']['hit_share']:.1f}% of rays opaque)"
               if "render_vs_cpu" in r else ""))
        res["runs"][run] = r
        del out, system
        if cuda:
            torch.cuda.empty_cache()
    return res


def phase_volume() -> dict:
    """Main path 7 on the card (``drive_volume`` at SD2.1 width)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_volume")
    res = drive_volume(work)
    res["counts"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                     for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def volume_kernel_rows(fwd: dict, bwd: dict) -> dict:
    """Per shape of the volume path (and of the DMTet path at B = 1): each
    kernel's max error and graph ms beside SDPA's graph ms and the bound."""
    pick = lambda r, keys: {k: r[k] for k in keys}
    return {
        "flash_attn_fwd": [pick(r, ("B", "N", "M", "H", "max_err", "graph_ms", "lib_graph_ms",
                                    "bound_ms", "by", "ms", "plain_ms"))
                           for res in fwd.values() for r in res["rows"]],
        "flash_attn_bwd_dq": [{**pick(r, ("B", "N", "M", "H")), "max_err": r["errs"]["dq"]["max"],
                               "graph_ms": r["dq_graph_ms"], "lib_graph_ms": r["lib_dq_graph_ms"],
                               "bound_ms": r["dq_bound_ms"], "by": r["dq_by"]}
                              for res in bwd.values() for r in res["rows"]],
        "flash_attn_bwd_dkv": [{**pick(r, ("B", "N", "M", "H")),
                                "max_err": max(r["errs"]["dk"]["max"], r["errs"]["dv"]["max"]),
                                "graph_ms": r["dkv_graph_ms"],
                                "lib_graph_ms": r["lib_dkv_graph_ms"],
                                "bound_ms": r["dkv_bound_ms"], "by": r["dkv_by"]}
                               for res in bwd.values() for r in res["rows"]],
    }


# Main path 8, the DMTet family: each run is (config, steps, texture stage,
# overrides). Fantasia3D's geometry stage takes its latent branch at steps 0
# and 1 (latent_steps=2) and the VAE branch at step 2.
DMTET_BLOCKS = {
    "geometry": ("system.geometry!={radius: 1.0, isosurface_resolution: 128, "
                 "shape_init: sphere, shape_init_params: 0.5, n_feature_dims: 3}"),
    "renderer": "system.renderer!={radius: 1.0}",
}
DMTET_RUNS = {
    "fantasia3d_geometry": ("configs/fantasia3d.yaml", 3, False, ["system.latent_steps=2"]),
    "fantasia3d_texture": ("configs/fantasia3d.yaml", 2, True, [
        "system.texture=true", "system.material_type=pbr-material",
        "system.material!={environment_texture: /nonexistent.hdr}",
        "system.geometry.n_feature_dims=8"]),
    "magic3d_refinement": ("configs/dreamfusion.yaml", 2, False, [
        "system_type=magic3d-system", "system.refinement=true",
        "system.geometry_type=tetrahedra-sdf-grid", DMTET_BLOCKS["geometry"],
        "system.renderer_type=nvdiff-rasterizer", DMTET_BLOCKS["renderer"],
        "system.material_type=no-material", "system.material!={n_output_dims: 3}",
        "system.background_type=solid-color-background", "system.background!={}",
        "system.loss!={lambda_sds: 1.0, lambda_normal_consistency: 1000.0}",
        "data.width=512", "data.height=512"]),
    "prolificdreamer_geometry": ("configs/prolificdreamer.yaml", 2, False, [
        "system.stage=geometry", DMTET_BLOCKS["geometry"], DMTET_BLOCKS["renderer"],
        "system.background!={color_activation: sigmoid}"]),
    "prolificdreamer_texture": ("configs/prolificdreamer.yaml", 2, True, [
        "system.stage=texture", DMTET_BLOCKS["geometry"], DMTET_BLOCKS["renderer"],
        "system.geometry.fix_geometry=true",
        "system.background!={color_activation: sigmoid}"]),
}
# the configs cut to the CPU tiny form
DMTET_TINY = [
    "system.guidance.model_size=tiny", "system.guidance.half_precision_weights=false",
    "system.guidance.width=24", "system.guidance.height=24",
    "system.prompt_processor.model_size=tiny", "system.geometry.isosurface_resolution=12",
    "system.geometry.max_crossing_tets=2048",
    "system.geometry.pos_encoding_config.n_levels=4",
    "system.geometry.pos_encoding_config.n_features_per_level=2",
    "system.geometry.pos_encoding_config.log2_hashmap_size=10",
    "system.geometry.pos_encoding_config.base_resolution=4",
    "system.geometry.pos_encoding_config.per_level_scale=1.5",
    "system.renderer.sdf_opacity_samples=8", "system.renderer.eval_chunk_rays=256",
    "data.width=24", "data.height=24", "data.eval_width=24", "data.eval_height=24",
]


def dmtet_argv(work: str, device: str, size: str, run: str) -> list:
    """``launch_torch.py --train`` of run ``run`` of ``DMTET_RUNS``: random
    weights, 1 test view, no validation or checkpoint; the CPU tiny form
    also builds the PBR material's split-sum stacks at 16^2."""
    config, steps, _, over = DMTET_RUNS[run]
    if size == "tiny" and "system.material_type=pbr-material" in over:
        over = over + ["system.material.splitsum_base_res=16"]
    return (["--config", config, "--train", "--device", device,
             "system.prompt_processor.prompt=a ceramic vase",
             "system.prompt_processor.use_cache=false", "system.guidance.cache_dir=null",
             "data.n_test_views=1", f"trainer.max_steps={steps}", "trainer.val_check_interval=0",
             "checkpoint.every_n_train_steps=0", f"exp_root_dir={work}/runs_{run}",
             "use_timestamp=false"] + over + (DMTET_TINY if size == "tiny" else []))


def morton_order(tri: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Slot order of a soup [F,3,3] by the 30-bit Morton code of each
    triangle's centroid in the box [lo, hi], invalid slots last."""
    q = torch.clamp((tri.mean(1) - lo) / (hi - lo), 0.0, 1.0) * 1023.0
    code = torch.zeros(tri.shape[0], dtype=torch.int64, device=tri.device)
    for axis in range(3):
        x = q[:, axis].long()
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        code = code | (x << (2 - axis))
    return torch.argsort(torch.where(valid, code, 1 << 31), stable=True)


def dmtet_cast_check(system, last, clock: Optional[float], n_check: int = 65536,
                     n_origin: int = 4096) -> dict:
    """Kernel B on the last training step's hit pass (its rays against its
    whole soup): the kernel's time, the pairs it tested, the pairs it tests
    on the soup in Morton order, the bound over the fewer of the two, and
    bit for bit against ``cast_rays_plain`` on ``n_check`` of its rays
    (evenly spaced); then ``n_origin`` rays through the origin, where every
    invalid slot (an all-zero triangle, id -1) lies, all checked, none of
    which may report an invalid slot. On the CPU both sides are the plain
    caster."""
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    ro, rd, tri, valid = last
    soup = system.renderer.soup_bvh(tri, valid)
    tri_data = bvh_lib._plane_tri_data(soup)
    idx = torch.linspace(0, ro.shape[0] - 1, min(n_check, ro.shape[0]),
                         device=ro.device).long()
    gen = torch.Generator(device=ro.device).manual_seed(0)
    d0 = torch.randn(n_origin, 3, generator=gen, device=ro.device)
    d0 = (d0 / d0.norm(dim=-1, keepdim=True)).contiguous()
    o0 = (-2.0 * d0).contiguous()
    rows = {}
    for name, o, d, sel in (("steps", ro, rd, idx), ("origin", o0, d0, None)):
        if ro.device.type == "cuda":
            rows[name] = _cast_case(f"DMTet hit pass ({name}) {o.shape[0]} rays", soup, tri_data,
                                    o, d, clock, check_idx=sel, chunk=256)
        else:
            sel = torch.arange(o.shape[0]) if sel is None else sel
            got = bvh_lib.cast_rays_dense(soup, o, d, tri_data=tri_data)
            if name == "origin":
                hits = got
            ref = bvh_lib.cast_rays_plain(soup, o[sel], d[sel], tri_data=tri_data)
            rows[name] = {"R": o.shape[0], "T": tri.shape[0], "checked": int(sel.shape[0]),
                          **cast_disagreement({k: v[sel] for k, v in got.items()}, ref)}
            if any(rows[name][k] for k in ("flips", "t_err", "face_diff", "uv_diff")):
                raise AssertionError(f"DMTet hit pass against the plain caster: {rows[name]}")
    if ro.device.type == "cuda":
        hits = bvh_lib.cast_rays_dense(soup, o0, d0, tri_data=tri_data)
    if not bool(valid[hits["face"][hits["hit"]].long()].all()):
        raise AssertionError("DMTet hit pass: a ray through the origin hit an invalid slot")
    row = dict(rows["steps"])
    row.update(rays=int(idx.shape[0]), valid_slots=int(valid.sum()),
               origin_rays=rows["origin"]["checked"],
               origin_hit_share=float(hits["hit"].float().mean()))
    if ro.device.type == "cuda":
        # the bound counts the fewer of the pairs the cull tests on the soup
        # as it is (slots in lattice order) and on the soup sorted by the
        # Morton code of its triangles' centroids: a spatial order, which
        # shows whether the lattice order flatters or hinders the cull
        ren = system.renderer
        order = morton_order(tri, valid, ren.bbox_lo, ren.bbox_hi)
        pairs_m = torch.zeros(1, dtype=torch.int64, device=ro.device)
        bvh_lib.cast_rays_dense(ren.soup_bvh(tri[order].contiguous(), valid[order]), ro, rd,
                                pairs_out=pairs_m)
        pm = float(pairs_m.item())
        b = cast_bounds(pm, ro.shape[0], tri.shape[0], clock)
        tested = {"bound_ms": row["bound_ms"], "by": row["by"]}
        least = min(tested, b, key=lambda x: x["bound_ms"])
        row.update(pairs_morton=pm, bound_tested_ms=tested["bound_ms"],
                   bound_morton_ms=b["bound_ms"], bound_ms=least["bound_ms"], by=least["by"])
        log(f"DMTet hit pass: pairs tested on the soup in Morton order {pm:.4g} "
            f"({100.0 * pm / (float(ro.shape[0]) * tri.shape[0]):.3f}% of R x T; in lattice "
            f"order {row['pairs']:.4g}), bound {row['bound_ms']:.4f} ms ({row['by']}); the "
            f"kernel {row['ms']:.3f} ms is {row['ms'] / row['bound_ms']:.1f}x that bound and "
            f"{row['ms'] / row['bound_all_pairs_ms']:.3f}x the all-pairs bound "
            f"{row['bound_all_pairs_ms']:.3f} ms")
    return row


def dmtet_breakdown(system, last, render_rgb: bool, profile: bool = False) -> dict:
    """Milliseconds (CUDA events, 3 calls) of the parts of a DMTet training
    render on the last step's rays and the trained scene: marching tets, the
    vertex normals, the hit pass, the SDF opacity (forward and backward; the
    forward alone under ``fix_geometry``), and the whole render forward and
    backward (``render_rgb`` as the stage renders); with ``profile`` also the
    device time of one render forward and backward and its 12 largest
    kernels (``torch.profiler``)."""
    from dreammat_tpu_torch.ops import dmtet

    ro, rd, tri, valid = last
    f, geo, ren = system.field, system.geometry, system.renderer
    mesh = geo.isosurface(f.geo)
    w = torch.rand(ro.shape[0], 1, device=ro.device)
    fixed = geo.cfg.fix_geometry

    def opacity():
        op = ren._sdf_opacity(f.geo, ro, rd)
        if not fixed:
            (op * w).sum().backward()

    def render_fb():
        out = ren.render_rays(f.geo, f.bg, f.occ, ro, rd, torch.zeros_like(ro), None,
                              is_train=True, render_rgb=render_rgb)
        (out["comp_rgb"] * w).sum().backward()

    if profile:
        # device time by kernel over one render forward and backward
        render_fb()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            render_fb()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, "device_time_total", 0))
        top = [{"name": e.key[:80], "ms": e.device_time_total / 1e3, "calls": e.count}
               for e in rows[:12]]
        total = sum(getattr(e, "device_time_total", 0) for e in rows) / 1e3
    res = {
        "marching_tets_ms": cuda_ms(lambda: geo.isosurface(f.geo), 3),
        "vertex_normals_ms": cuda_ms(lambda: dmtet.vertex_normals_by_gid(
            mesh.tri_verts, mesh.valid, mesh.edge_gid), 3),
        "hit_pass_ms": cuda_ms(lambda: ren._cast(ro, rd, tri, valid), 3),
        ("sdf_opacity_fwd_ms" if fixed else "sdf_opacity_fwd_bwd_ms"): cuda_ms(opacity, 3),
        "render_fwd_bwd_ms": cuda_ms(render_fb, 3),
    }
    if profile:
        res["profile_device_ms"], res["profile_top"] = total, top
    for p in f.parameters():
        p.grad = None
    return res


def dmtet_sync_check(system, last, render_rgb: bool) -> dict:
    """The mesh part of a training step (the isosurface, the hit pass, the
    render as the stage renders, the mesh losses and their backward) on the
    last step's rays under ``torch.cuda.set_sync_debug_mode("warn")``: no
    operation may synchronize with the host. A ``.item()`` first shows that
    the mode sees a sync."""
    import warnings

    from dreammat_tpu_torch.ops import dmtet

    ro, rd, _, _ = last
    f, ren = system.field, system.renderer
    w = torch.rand(ro.shape[0], 1, device=ro.device)
    syncs = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            w.sum().item()
            control = len(seen)
            out = ren.render_rays(f.geo, f.bg, f.occ, ro, rd, torch.zeros_like(ro), None,
                                  step=system.global_step, is_train=True, render_rgb=render_rgb)
            loss = (out["comp_rgb"] * w).sum()
            if not system.geometry.cfg.fix_geometry:
                loss = loss + dmtet.normal_consistency(*out["mesh"], vn=out["vertex_normals"]) \
                    + dmtet.laplacian_smoothness(*out["mesh"])
            loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{os.path.basename(x.filename)}:{x.lineno}: {str(x.message)[:80]}"
                 for x in seen[control:] if "synchroniz" in str(x.message)]
    for p in f.parameters():
        p.grad = None
    if control < 1 or syncs:
        raise AssertionError(f"DMTet step's mesh part: the control sync seen {control} times; "
                             f"syncs in the step: {syncs}")
    return {"control_syncs_seen": control, "syncs": len(syncs)}


def dmtet_render_vs_cpu(system, dm, cfg, n_rays: int = 2048) -> dict:
    """``n_rays`` rays of eval view 0 (evenly spaced) rendered by the trained
    scene on the card and, from a copy of it, by the same system built on
    the CPU: the share of rays whose hit differs (kernel B against the plain
    caster on soups extracted on either side; at most 1e-3) and the max
    |diff| of the colour, opacity and depth where the hits agree (2e-3).
    The CPU side's soup is cut after its last valid slot."""
    import copy

    import dreammat_tpu_torch

    batch = dm.eval_rays(0)
    ro, rd = batch["rays_o"].reshape(-1, 3), batch["rays_d"].reshape(-1, 3)
    idx = torch.linspace(0, ro.shape[0] - 1, n_rays, device=ro.device).long()
    ro, rd = ro[idx].contiguous(), rd[idx].contiguous()
    lp = batch["light_position"].reshape(1, 3).expand_as(ro)
    seconds = {}
    t0 = time.time()
    cpu_sys = dreammat_tpu_torch.find(cfg.system_type)(cfg.system, device="cpu")
    field = copy.deepcopy(system.field).cpu()
    seconds["cpu_build"] = time.time() - t0
    step = system.global_step
    with torch.no_grad():
        card = system.renderer.render_rays(system.field.geo, system.field.bg, None, ro, rd, lp,
                                           None, step=step)
        t0 = time.time()
        mesh = cpu_sys.geometry.isosurface(field.geo)
        # the soup cut after its last valid slot: the slots past it are
        # invalid (never hit, no part in the vertex normals), so the render
        # is the same, and the plain caster on the CPU has a third less work
        n_live = int(torch.nonzero(mesh.valid).max()) + 1
        mesh = type(mesh)(*(x[:n_live] for x in mesh))
        seconds["cpu_isosurface"] = time.time() - t0
        t0 = time.time()
        cpu = cpu_sys.renderer.render_rays(field.geo, field.bg, None, ro.cpu(), rd.cpu(),
                                           lp.cpu(), None, step=step, mesh=mesh)
        seconds["cpu_render"] = time.time() - t0
    same = card["hit"].cpu() == cpu["hit"]
    res = {"rays": n_rays, "hit_share": float(cpu["hit"].float().mean()),
           "hit_flips": int((~same).sum()), "seconds": seconds}
    for key in ("comp_rgb", "opacity", "depth", "comp_normal"):
        res[key] = (card[key].cpu() - cpu[key])[same].abs().max().item()
    if res["hit_flips"] > 1e-3 * n_rays or not max(
            res[k] for k in ("comp_rgb", "opacity", "depth", "comp_normal")) <= 2e-3:
        raise AssertionError(f"DMTet render, card against the CPU: {res}")
    log(f"DMTet render card vs CPU: CPU seconds {seconds}")
    return res


def drive_dmtet(work: str, device: str = "cuda", size: str = "sd21",
                clock: Optional[float] = None) -> dict:
    """Main path 8, the DMTet family, through ``launch_torch.py --train`` of
    each run of ``DMTET_RUNS`` at SD2.1 width with random weights, 512^2
    renders, ``isosurface_resolution`` 128 with the default budget of 2^17
    crossing tets (262,144 triangle slots), 1 test view. Per run: finite
    losses; geometry stages moved the SDF, texture stages left it unchanged
    (checksum) and moved the feature MLP; the test PNG, and for
    Fantasia3D's geometry stage ``model.obj`` with vertices and faces and
    the guidance branch of each step. On the card also: kernel B exactly one
    launch per training step plus one per eval chunk, kernel A by batch and
    C and D as ``VOLUME_PER_STEP`` says for the guidance; kernel B on the last
    step's hit pass bit for bit against the plain caster (65,536 rays in
    the first run, 16,384 after), with its time, pairs tested and bound;
    the step's parts (``dmtet_breakdown``); and, for the first run, 2048
    eval rays on the card against the CPU. Returns each run's numbers; raises on a failed
    check."""
    import shutil

    import launch_torch
    from dreammat_tpu_torch.models.guidance_sds import StableDiffusionGuidance
    from dreammat_tpu_torch.models.mesh_rasterizer import MeshRasterizer
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.systems.dreamfusion import DreamFusion
    from dreammat_tpu_torch.systems.dreammat import DreamMat

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(work, ignore_errors=True)
    kernels_a = (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
                 attn.flash_attention_bwd_dkv)
    res = {"runs": {}, "cast_vs_plain": None, "render_vs_cpu": None}
    for run, (config, steps, texture, _) in DMTET_RUNS.items():
        last, branches = [], []
        real_cast, real_sds = MeshRasterizer._cast, StableDiffusionGuidance.__call__

        def cast(self, ro, rd, tri, valid):
            if torch.is_grad_enabled():  # a training render (eval renders run under no_grad)
                last[:] = [ro.float().contiguous(), rd.float().contiguous(), tri, valid]
            return real_cast(self, ro, rd, tri, valid)

        def sds(self, *a, **k):
            branches.append("latent" if k.get("rgb_as_latents") else "rgb")
            return real_sds(self, *a, **k)

        MeshRasterizer._cast, StableDiffusionGuidance.__call__ = cast, sds
        stages = StageLaunches()
        stages.wrap(DreamMat, "fit", "train")
        stages.wrap(DreamFusion, "test", "test")
        for fn in kernels_a:
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            with AttentionBatches() as batches:
                out = launch_torch.main(dmtet_argv(work, device, size, run))
        finally:
            MeshRasterizer._cast, StableDiffusionGuidance.__call__ = real_cast, real_sds
            stages.restore()
        sync()
        system, trial, cfg = out["system"], out["trial_dir"], out["cfg"]
        dm = out["datamodule"]
        fresh = system.geometry.init(torch.Generator(device=device).manual_seed(cfg.seed))
        geo = system.field.geo
        step_s = list(system.step_seconds)
        eval_chunks = math.ceil(dm.cfg.eval_height * dm.cfg.eval_width
                                / system.renderer.cfg.eval_chunk_rays)
        r = {"seconds": time.time() - t0, "system": type(system).__name__,
             "guidance": type(system.guidance).__name__, "steps": steps, "texture": texture,
             "render_hw": [dm.cfg.height, dm.cfg.width],
             "isosurface_resolution": system.geometry.cfg.isosurface_resolution,
             "slots": 2 * system.geometry.cfg.max_crossing_tets,
             "ray_cast": dict(stages.counts), "eval_chunks": eval_chunks,
             "stage_seconds": dict(stages.seconds),
             "launches": {"flash_attn_fwd": kernels_a[0].launches,
                          "flash_attn_bwd_dq": kernels_a[1].launches,
                          "flash_attn_bwd_dkv": kernels_a[2].launches},
             "flash_attn_fwd_by_batch": dict(batches.counts), "branches": branches,
             "step_s": step_s, "warm_step_s": float(np.mean(step_s[1:] or step_s)),
             "test_s": list(system.test_seconds), "losses": list(system.step_losses),
             "step_peak_gb": list(system.step_peak_gb),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
             "sdf_moved": (geo.sdf.detach() - fresh.sdf).abs().max().item(),
             "sdf_changed": int(tensor_checksum(geo.sdf) != tensor_checksum(fresh.sdf)),
             "feature_moved": max((p.detach() - q.detach()).abs().max().item() for p, q in zip(
                 geo.feature_mlp.parameters(), fresh.feature_mlp.parameters()))}
        if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"path 8 {run}: losses {r['losses']}")
        if texture and not (r["sdf_changed"] == 0 and r["feature_moved"] > 0):
            raise AssertionError(f"path 8 {run}: texture stage moved the SDF or not the "
                                 f"features: {r['sdf_changed']}, {r['feature_moved']}")
        if not texture and not r["sdf_moved"] > 0:
            raise AssertionError(f"path 8 {run}: the SDF did not move")
        save = os.path.join(trial, "save")
        r["test_png"] = check_file(os.path.join(save, f"it{steps}-test", "0.png"),
                                   b"\x89PNG\r\n\x1a\n", 100)
        if run == "fantasia3d_geometry":
            with open(os.path.join(save, "export", "model.obj")) as fh:
                lines = fh.read().splitlines()
            r["obj_v"] = sum(ln.startswith("v ") for ln in lines)
            r["obj_f"] = sum(ln.startswith("f ") for ln in lines)
            latent = dict(cfg.system)["latent_steps"]
            if not (r["obj_v"] > 0 and r["obj_f"] > 0) or branches != [
                    "latent" if i < latent else "rgb" for i in range(steps)]:
                raise AssertionError(f"path 8 {run}: model.obj {r['obj_v']} v, {r['obj_f']} f;"
                                     f" branches {branches}")
        if cuda:
            want = VOLUME_PER_STEP["prolificdreamer" if run.startswith("prolificdreamer")
                                   else "dreamfusion"]
            want_fwd = {b: n * steps for b, n in want["fwd_by_batch"].items()}
            if (r["ray_cast"] != {"train": steps, "test": eval_chunks}
                    or r["flash_attn_fwd_by_batch"] != want_fwd
                    or r["launches"]["flash_attn_bwd_dq"] != want["dq"] * steps
                    or r["launches"]["flash_attn_bwd_dkv"] != want["dkv"] * steps):
                raise AssertionError(
                    f"path 8 {run}: kernel B by stage {r['ray_cast']} (expected {steps} and "
                    f"{eval_chunks}), kernel A by batch {r['flash_attn_fwd_by_batch']} "
                    f"(expected {want_fwd}), C and D {r['launches']}")
            t1 = time.time()
            r["breakdown"] = dmtet_breakdown(system, last, render_rgb=not (
                run.endswith("geometry")), profile=run == "fantasia3d_geometry")
            r["breakdown"]["seconds"] = time.time() - t1
            r["sync_check"] = dmtet_sync_check(system, last, render_rgb=not (
                run.endswith("geometry")))
        first = run == next(iter(DMTET_RUNS))
        t1 = time.time()
        # the CPU form checks the plain caster against itself: 2048 rays and
        # 1024 through the origin do
        r["cast_vs_plain"] = dmtet_cast_check(system, last, clock, n_check=(
            65536 if first else 16384) if cuda else 2048, n_origin=4096 if cuda else 1024)
        r["check_seconds"] = {"cast_vs_plain": time.time() - t1}
        if cuda and first:
            t1 = time.time()
            r["render_vs_cpu"] = dmtet_render_vs_cpu(system, dm, cfg)
            r["check_seconds"]["render_vs_cpu"] = time.time() - t1
        c = r["cast_vs_plain"]
        log(f"dmtet {run} ({r['guidance']}, {r['render_hw'][0]}^2, DMTet "
            f"{r['isosurface_resolution']}, {r['slots']} slots): launch_torch.py --train in "
            f"{r['seconds']:.1f}s; kernel B by stage {r['ray_cast']}; kernel A by batch "
            f"{r['flash_attn_fwd_by_batch']}, C {r['launches']['flash_attn_bwd_dq']}, D "
            f"{r['launches']['flash_attn_bwd_dkv']}; branches {branches}; steps "
            f"{', '.join(f'{x:.4f}s' for x in step_s)} (warm {r['warm_step_s']:.4f}s), peak "
            f"{', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])} (run {r['peak_gb'] or 0:.2f}"
            f" GB); stage seconds {r['stage_seconds']}; test view "
            f"{', '.join(f'{x:.3f}s' for x in r['test_s'])}; SDF moved {r['sdf_moved']:.3g}, "
            f"changed {r['sdf_changed']}, features moved {r['feature_moved']:.3g}; losses "
            f"{', '.join(f'{x:.6g}' for x in r['losses'])}; hit pass: {c['valid_slots']} valid "
            f"slots, {c['checked']} rays bit for bit equal to the plain caster; checks "
            f"{ {k: round(v, 2) for k, v in r['check_seconds'].items()} }"
            + (f"; breakdown {r['breakdown']}" if "breakdown" in r else "")
            + (f"; host syncs in the mesh part of a step {r['sync_check']['syncs']} (control "
               f"{r['sync_check']['control_syncs_seen']})" if "sync_check" in r else "")
            + (f"; {r['render_vs_cpu']['rays']} eval rays card vs CPU: hit flips "
               f"{r['render_vs_cpu']['hit_flips']}, comp_rgb {r['render_vs_cpu']['comp_rgb']:.2e},"
               f" opacity {r['render_vs_cpu']['opacity']:.2e}, depth "
               f"{r['render_vs_cpu']['depth']:.2e}, comp_normal "
               f"{r['render_vs_cpu']['comp_normal']:.2e} ({100 * r['render_vs_cpu']['hit_share']:.1f}"
               f"% of rays hit)" if "render_vs_cpu" in r else ""))
        res["runs"][run] = r
        res["cast_vs_plain"] = c
        res["render_vs_cpu"] = r.get("render_vs_cpu", res["render_vs_cpu"])
        del out, system, fresh, last
        if cuda:
            torch.cuda.empty_cache()
    return res


def phase_dmtet(clock: float) -> dict:
    """Main path 8 on the card (``drive_dmtet`` at SD2.1 width)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_dmtet")
    res = drive_dmtet(work, clock=clock)
    res["counts"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                     for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    res["counts"]["ray_cast"] = sum(sum(r["ray_cast"].values()) for r in res["runs"].values())
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# Main path 9, the rest of the volume family: Latent-NeRF's latent stage and
# its refinement and SJC on configs/sjc_tiny.yaml with its blocks replaced
# (SD2.1 width, 512^2 renders through the patch renderer), and TextMesh on
# configs/textmesh.yaml, its renders cut from 512^2 to 64^2: NeuS takes all
# 512 samples of every ray with the finite-difference normals (4 hash-grid
# queries a sample), and 128^2 ran out of the card's 80 GB. Each run is
# (config, overrides at SD2.1 width, overrides of the CPU tiny form, the
# isosurface level of the export).
VOLUME_REST_PATCH = ("system.renderer!={patch_size: %d, global_downsample: 4, base_renderer: "
                     "{radius: 1.0, num_samples_per_ray: %d, grid_resolution: %d, "
                     "grid_update_every: 2, eval_chunk_rays: %d}}")
VOLUME_REST_SD21 = [
    "system.guidance!={model_size: sd21, half_precision_weights: true, use_controlnet: false, "
    "guidance_scale: 100.0, width: 512, height: 512, cache_dir: null}",
    "system.prompt_processor!={model_size: sd21, prompt: a ceramic vase, use_cache: false}",
    "system.renderer_type=patch-renderer", VOLUME_REST_PATCH % (128, 512, 32, 8192),
    "data.width=512", "data.height=512",
]
VOLUME_REST_TINY = [
    "system.guidance.model_size=tiny", "system.guidance.half_precision_weights=false",
    "system.guidance.width=24", "system.guidance.height=24",
    "system.prompt_processor.model_size=tiny", "system.prompt_processor.use_cache=false",
    "system.renderer_type=patch-renderer", VOLUME_REST_PATCH % (8, 32, 8, 256),
    "data.width=24", "data.height=24",
]
VOLUME_REST_LATENT = ["system_type=latentnerf-system", "system.loss.lambda_shape=1.0"]
VOLUME_REST_RUNS = {
    "latentnerf": ("configs/sjc_tiny.yaml", VOLUME_REST_LATENT + VOLUME_REST_SD21 + [
        "system.geometry!={radius: 1.0, n_feature_dims: 4}", "system.guide_shape_grid_res=64",
        "data.eval_width=64", "data.eval_height=64"],
        VOLUME_REST_LATENT + VOLUME_REST_TINY + ["system.guide_shape_grid_res=12"], 5.0),
    "latentnerf_refine": ("configs/sjc_tiny.yaml", VOLUME_REST_LATENT + VOLUME_REST_SD21 + [
        "system.geometry!={radius: 1.0, n_feature_dims: 4}", "system.guide_shape_grid_res=64",
        "system.refinement=true", "system.material_type=sd-latent-adapter-material",
        "system.material!={}", "data.eval_width=512", "data.eval_height=512"],
        VOLUME_REST_LATENT + VOLUME_REST_TINY + [
            "system.guide_shape_grid_res=12", "system.refinement=true",
            "system.material_type=sd-latent-adapter-material", "system.material!={}"], 5.0),
    "sjc": ("configs/sjc_tiny.yaml", [
        "system.guidance.model_size=sd21", "system.guidance.half_precision_weights=true",
        "system.guidance.width=512", "system.guidance.height=512",
        "system.prompt_processor.model_size=sd21", *VOLUME_REST_SD21[2:],
        "system.geometry_type=volume-grid",
        "system.geometry!={grid_size: [100, 100, 100], n_feature_dims: 4}",
        "system.background_type=textured-background",
        "system.background!={n_output_dims: 4, height: 64, width: 64, color_activation: none}",
        "data.eval_width=64", "data.eval_height=64"], VOLUME_REST_TINY + [
            "system.geometry_type=volume-grid",
            "system.geometry!={grid_size: [16, 16, 16], n_feature_dims: 4}",
            "system.background_type=textured-background",
            "system.background!={n_output_dims: 4, height: 8, width: 8, "
            "color_activation: none}"], 1.0),
    "textmesh": ("configs/textmesh.yaml", [
        "system.renderer.grid_update_every=2", "data.width=64", "data.height=64",
        "data.eval_width=64", "data.eval_height=64"], [
            "system.guidance.model_size=tiny", "system.guidance.half_precision_weights=false",
            "system.guidance.width=24", "system.guidance.height=24",
            "system.prompt_processor.model_size=tiny", "system.prompt_processor.use_cache=false",
            "system.geometry.pos_encoding_config.n_levels=4",
            "system.geometry.pos_encoding_config.log2_hashmap_size=10",
            "system.geometry.pos_encoding_config.base_resolution=4",
            "system.geometry.pos_encoding_config.per_level_scale=1.5",
            "system.geometry.isosurface_resolution=24", "system.renderer.num_samples_per_ray=32",
            "system.renderer.grid_resolution=8", "system.renderer.eval_chunk_rays=256",
            "system.renderer.grid_update_every=2", "data.width=24", "data.height=24",
            "data.eval_width=24", "data.eval_height=24"], 0.0),
}


def volume_rest_argv(work: str, device: str, size: str, run: str, steps: int,
                     guide: Optional[str]) -> list:
    """``launch_torch.py --train`` of run ``run`` of ``VOLUME_REST_RUNS``:
    random weights, ``steps`` steps, 1 test view, no validation or
    checkpoint, the isosurface export at the run's level; the Latent-NeRF
    runs with the ``guide`` mesh as their guide shape."""
    config, sd21, tiny, level = VOLUME_REST_RUNS[run]
    argv = ["--config", config, "--train", "--device", device,
            "system.prompt_processor.prompt=a ceramic vase",
            "system.prompt_processor.use_cache=false", "system.guidance.cache_dir=null",
            "data.n_test_views=1", f"trainer.max_steps={steps}", "trainer.val_check_interval=0",
            "checkpoint.every_n_train_steps=0", f"exp_root_dir={work}/runs_{run}",
            "use_timestamp=false"] + (tiny if size == "tiny" else sd21)
    argv.append(f"system.geometry.isosurface_threshold={level}")
    if run.startswith("latentnerf"):
        argv.append(f"system.guide_shape={guide}")
    return argv


def guide_vs_cpu(system, n_check: int = 2048) -> dict:
    """The guide's winding-number grid baked on the card against the same
    bake on the CPU at ``n_check`` voxels drawn from the lattice (the whole
    lattice on the CPU would take minutes): the share whose inside/outside
    indicator differs (at most 1e-3: grazing sums) and the max |diff|."""
    from dreammat_tpu_torch.models.mesh import _LOADERS
    from dreammat_tpu_torch.ops import shape_loss as shape_ops

    grid = system.shape_grid
    G = grid.winding.shape[0]
    tri = torch.from_numpy(shape_ops.guide_triangles(*_LOADERS[".obj"](system.cfg.guide_shape)[:2]))
    idx = torch.randperm(G ** 3, generator=torch.Generator().manual_seed(0))[:n_check]
    g = torch.linspace(-grid.bound, grid.bound, G)
    pts = torch.stack([g[idx // (G * G)], g[(idx // G) % G], g[idx % G]], dim=-1)
    t0 = time.time()
    cpu = shape_ops.winding_number(pts, tri, chunk=256)
    card = grid.winding.reshape(-1)[idx.to(grid.winding.device)].cpu()
    flips = int(((card > 0.5) != (cpu > 0.5)).sum())
    res = {"voxels": int(idx.numel()), "grid": G, "inside_share": float((cpu > 0.5).float().mean()),
           "indicator_flips": flips, "max_abs_diff": float((card - cpu).abs().max()),
           "cpu_s": time.time() - t0}
    if flips > 1e-3 * idx.numel() or not 0 < res["inside_share"] < 1:
        raise AssertionError(f"guide grid, card against the CPU: {res}")
    return res


def volume_rest_breakdown(system, dm, step: int) -> dict:
    """CUDA-event ms of a training render's forward and backward on a fresh
    batch (``render``), and for the patch renderer its global pass, its
    patch pass (each forward and backward) and the merge (forward): the
    render's share of a step."""
    from dreammat_tpu_torch.models.volume_renderer import PrefixedDraws
    from dreammat_tpu_torch.utils.rng import TorchDraws

    batch = dm.collate(step=step)
    draws = TorchDraws(step, system.device)
    params = list(system.field.parameters())

    def backward(out):
        (out["comp_rgb"].float().sum() + out["opacity"].sum()).backward()
        for p in params:
            p.grad = None

    res = {"render": cuda_ms(lambda: backward(system.render_batch(batch, draws, True)), 3)}
    r = system.renderer
    if hasattr(r, "merge"):
        f = system.field
        H = W = batch["height"]
        ds, PS = r.cfg.global_downsample, min(r.cfg.patch_size, H)
        grids = [batch[k].reshape(H, W, 3) for k in ("rays_o", "rays_d", "light_positions")]
        sub = [x[ds // 2::ds, ds // 2::ds].reshape(-1, 3) for x in grids]
        patch = [x[:PS, :PS].reshape(-1, 3) for x in grids]
        run = lambda rays, prefix: r.base.render_rays(
            f.geo, f.bg, f.occ, *rays, PrefixedDraws(draws, prefix), step=step, is_train=True)
        res["global_pass"] = cuda_ms(lambda: backward(run(sub, "global/")), 3)
        res["patch_pass"] = cuda_ms(lambda: backward(run(patch, "patch/")), 3)
        with torch.no_grad():
            out_g, out_p = run(sub, "global/"), run(patch, "patch/")
        res["merge"] = cuda_ms(lambda: r.merge(out_g, out_p, H, W, 0, 0), 10)
    return res


def drive_volume_rest(work: str, device: str = "cuda", size: str = "sd21",
                      steps: int = 3) -> dict:
    """Main path 9 through ``launch_torch.py --train`` of each run of
    ``VOLUME_REST_RUNS`` (``volume_rest_argv``): Latent-NeRF (4 latent
    channels, a 512^2 render through the patch renderer, 128^2 patch and
    128^2 strided global pass, guide shape the torus of main path 3 baked at
    64^3, eval at 64^2 decoded to 512^2), its refinement (RGB with
    ``sd-latent-adapter-material`` and the VAE encode, eval at 512^2), SJC (a
    100^3 ``volume-grid`` and a 64 x 64 ``textured-background``, as
    Latent-NeRF's renders) and TextMesh (NeuS over ``implicit-sdf``,
    ``configs/textmesh.yaml`` cut to 64^2), at SD2.1 width with random
    weights, ``steps`` steps with the occupancy refresh every 2, 1 test view.
    Per run: finite losses and parameters; the field moved (checksums), and
    for TextMesh the NeuS variance; the occupancy grid refreshed at init and
    at every second step; the test PNG, and ``model.obj`` with vertices and
    faces at the run's level; for Latent-NeRF the guide's grid on the card
    against the CPU (``guide_vs_cpu``). On the card also kernel A exactly 32
    launches a step at B = 2 and C, D and B none, 2048 rays of eval view 0
    on the card and on the CPU within 2e-3 (``volume_render_vs_cpu``: through
    the patch renderer's hand-over to the base renderer, or NeuS), and the
    render's share of a step (``volume_rest_breakdown``).
    Returns each run's numbers; raises on a failed check."""
    import shutil

    import launch_torch
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj
    from dreammat_tpu_torch.models.volume_renderer import NeRFVolumeRenderer
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(work, ignore_errors=True)
    guide = write_obj(os.path.join(work, "torus.obj"),
                      *torus_arrays(0.7, 0.28, *((192, 96) if size != "tiny" else (24, 12))))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv,
                "ray_cast": bvh_lib.cast_rays_dense}
    res = {"runs": {}}
    for run in VOLUME_REST_RUNS:
        refreshes, start = [], {}
        real_update = NeRFVolumeRenderer.update_occ

        def update_occ(self, geo_field, *a, **k):
            if not refreshes:  # init_state's refresh: the field as training starts
                start.update({n: tensor_checksum(p) for n, p in geo_field.named_parameters()})
            refreshes.append(1)
            return real_update(self, geo_field, *a, **k)

        NeRFVolumeRenderer.update_occ = update_occ
        for fn in counters.values():
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            with AttentionBatches() as batches:
                out = launch_torch.main(volume_rest_argv(work, device, size, run, steps, guide))
        finally:
            NeRFVolumeRenderer.update_occ = real_update
        sync()
        system, trial, cfg = out["system"], out["trial_dir"], out["cfg"]
        step_s = list(system.step_seconds)
        field = system.field
        r = {"seconds": time.time() - t0, "system": type(system).__name__,
             "renderer": type(system.renderer).__name__,
             "geometry": type(system.geometry).__name__,
             "render_hw": [out["datamodule"].cfg.height, out["datamodule"].cfg.width],
             "eval_hw": [out["datamodule"].cfg.eval_height, out["datamodule"].cfg.eval_width],
             "launches": {k: fn.launches for k, fn in counters.items()},
             "flash_attn_fwd_by_batch": dict(batches.counts), "occ_refreshes": len(refreshes),
             "step_s": step_s, "warm_step_s": float(np.mean(step_s[1:] or step_s)),
             "test_s": list(system.test_seconds), "losses": list(system.step_losses),
             "step_peak_gb": list(system.step_peak_gb),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
             "geo_moved": sum(tensor_checksum(p) != start[n]
                              for n, p in field.geo.named_parameters()),
             "geo_tensors": len(start)}
        if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"path 9 {run}: losses {r['losses']}")
        if not all(torch.isfinite(p).all() for p in field.parameters()):
            raise AssertionError(f"path 9 {run}: a parameter is not finite")
        if r["geo_moved"] == 0:
            raise AssertionError(f"path 9 {run}: the field did not move")
        if hasattr(field, "var"):
            r["inv_std_raw"] = float(field.var._inv_std.detach())
            if r["inv_std_raw"] == system.renderer.cfg.learned_variance_init:
                raise AssertionError(f"path 9 {run}: the NeuS variance did not move")
        with torch.no_grad():
            dens = system.geometry.apply(field.geo, torch.zeros(1, 3, device=device))
        r["centre_value"] = float(dens.get("density", dens.get("sdf"))[0, 0])
        if not math.isfinite(r["centre_value"]):
            raise AssertionError(f"path 9 {run}: the field at the centre is {r['centre_value']}")
        if r["occ_refreshes"] != 1 + len(range(0, steps, 2)):
            raise AssertionError(f"path 9 {run}: {r['occ_refreshes']} occupancy refreshes")
        save = os.path.join(trial, "save")
        r["test_png"] = check_file(os.path.join(save, f"it{steps}-test", "0.png"),
                                   b"\x89PNG\r\n\x1a\n", 100)
        with open(os.path.join(save, "export", "model.obj")) as f:
            lines = f.read().splitlines()
        r["obj_v"] = sum(ln.startswith("v ") for ln in lines)
        r["obj_f"] = sum(ln.startswith("f ") for ln in lines)
        if not (r["obj_v"] > 0 and r["obj_f"] > 0):
            raise AssertionError(f"path 9 {run}: model.obj has {r['obj_v']} v, {r['obj_f']} f")
        if run == "latentnerf":  # the refinement bakes the same grid
            r["guide_vs_cpu"] = guide_vs_cpu(system)
        if cuda:
            r["render_vs_cpu"] = volume_render_vs_cpu(system, out["datamodule"], cfg)
            r["render_ms"] = volume_rest_breakdown(system, out["datamodule"], steps)
            r["render_share"] = r["render_ms"]["render"] / (1e3 * r["warm_step_s"])
            want = {2: UNET_ATTENTIONS * steps}
            if (r["flash_attn_fwd_by_batch"] != want
                    or any(r["launches"][k] for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                                                       "ray_cast"))):
                raise AssertionError(f"path 9 {run}: kernel A by batch "
                                     f"{r['flash_attn_fwd_by_batch']} (expected {want}), "
                                     f"launches {r['launches']}")
        log(f"volume_rest {run} ({r['system']}, {r['geometry']}, {r['renderer']}, "
            f"{r['render_hw'][0]}^2 renders, eval {r['eval_hw'][0]}^2): launch_torch.py --train "
            f"in {r['seconds']:.1f}s; kernel A by batch {r['flash_attn_fwd_by_batch']}, launches "
            f"{r['launches']}; occupancy refreshes {r['occ_refreshes']}; steps "
            f"{', '.join(f'{x:.4f}s' for x in step_s)} (warm {r['warm_step_s']:.4f}s), peak "
            f"{', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])} (run {r['peak_gb'] or 0:.2f}"
            f" GB); test view {', '.join(f'{x:.3f}s' for x in r['test_s'])}; model.obj "
            f"{r['obj_v']} v, {r['obj_f']} f; field tensors moved {r['geo_moved']} of "
            f"{r['geo_tensors']}; losses {', '.join(f'{x:.6g}' for x in r['losses'])}"
            + (f"; NeuS raw variance {r['inv_std_raw']:.6g}" if "inv_std_raw" in r else "")
            + (f"; render forward and backward ms {r['render_ms']} ("
               f"{100 * r['render_share']:.1f}% of the warm step)" if "render_ms" in r else "")
            + (f"; guide grid card vs CPU {r['guide_vs_cpu']}" if "guide_vs_cpu" in r else "")
            + (f"; {r['render_vs_cpu']['rays']} eval rays card vs CPU: comp_rgb "
               f"{r['render_vs_cpu']['comp_rgb']:.2e}, opacity {r['render_vs_cpu']['opacity']:.2e}"
               f", depth (relative) {r['render_vs_cpu']['depth']:.2e} ("
               f"{100 * r['render_vs_cpu']['hit_share']:.1f}% of rays opaque)"
               if "render_vs_cpu" in r else ""))
        res["runs"][run] = r
        del out, system, field
        if cuda:
            torch.cuda.empty_cache()
    return res


def phase_volume_rest() -> dict:
    """Main path 9 on the card (``drive_volume_rest`` at SD2.1 width)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_volume_rest")
    res = drive_volume_rest(work)
    res["counts"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                     for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                               "ray_cast")}
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# Main path 10, the single-image family and DeepFloyd IF. The input image is
# a render of the torus of main path 3, turned to face the reference camera
# and scaled to its view. Zero123's volume runs render at SINGLE_IMAGE_RES,
# the largest side that fits the card (the reference view and the random
# view in one render, 512 samples, 8 hash-grid queries a sample with the
# normal perturbation: configs/zero123.yaml's 128^2, 134M queries, runs out
# of memory, 64^2 peaks at 75.3 GB; PERF.md section 5); the prompted SD
# guidance encodes the render at its own size, so those runs render at 64^2
# (latents that divide by 8) without the normal perturbation; the refinement
# runs at 512^2 (DMTet resolution 128).
SINGLE_IMAGE_RES = 64
SINGLE_IMAGE_SD_RES = 64
SINGLE_IMAGE_REFINE_RES = 512
SINGLE_IMAGE_INPUT_RES = 512
SINGLE_IMAGE_PROMPT = "a glazed ceramic ring"
_Z123_FULL = ("{model_size: zero123, half_precision_weights: true, cache_dir: null, "
              "cond_image_path: %s, cond_elevation_deg: 0.0, cond_azimuth_deg: 0.0, "
              "cond_camera_distance: 3.8, guidance_scale: 3.0, width: 256, height: 256}")
_Z123_TINY = ("{model_size: tiny, half_precision_weights: false, cache_dir: null, "
              "cond_image_path: %s, cond_camera_distance: 3.8, guidance_scale: 3.0, "
              "width: 24, height: 24}")
_SD_BLOCK = {"sd21": ("system.guidance!={model_size: sd21, half_precision_weights: true, "
                      "use_controlnet: false, guidance_scale: 100.0, cache_dir: null}"),
             "tiny": ("system.guidance!={model_size: tiny, half_precision_weights: false, "
                      "use_controlnet: false, guidance_scale: 100.0, cache_dir: null}")}
_SD_PROMPT = ("system.prompt_processor!={model_size: %s, prompt: " + SINGLE_IMAGE_PROMPT
              + ", use_cache: false}")
_DMTET = ["system.refinement=true",
          "system.geometry!={radius: 1.0, isosurface_resolution: %d, shape_init: sphere, "
          "shape_init_params: 0.5, n_feature_dims: 3}", "system.renderer!={radius: 1.0}"]
_MAGIC123_LOSS = ("system.loss!={lambda_sds: 0.025, lambda_3d_sds: 1.0, lambda_rgb: 1000.0, "
                  "lambda_mask: 100.0, lambda_orient: 1.0, lambda_normal_smoothness_2d: 1.0, "
                  "lambda_normal_consistency: 1000.0, lambda_laplacian_smoothness: 10.0}")
# configs/zero123.yaml cut to the CPU tiny form
SINGLE_IMAGE_TINY = [
    "system.geometry.pos_encoding_config={otype: HashGrid, n_levels: 4, "
    "n_features_per_level: 2, log2_hashmap_size: 10, base_resolution: 4, per_level_scale: 1.5}",
    "system.geometry.isosurface_resolution=24", "system.renderer.num_samples_per_ray=16",
    "system.renderer.grid_resolution=8", "system.renderer.eval_chunk_rays=256",
]
# per run: (config, kind, kernel A launches a step by batch)
SINGLE_IMAGE_RUNS = {
    "zero123": ("configs/zero123.yaml", "zero123", {2: UNET_ATTENTIONS}),
    "zero123_simple": ("configs/zero123.yaml", "simple", {2: UNET_ATTENTIONS}),
    "image_condition_dreamfusion": ("configs/zero123.yaml", "icdf", {2: UNET_ATTENTIONS}),
    "zero123_refine": ("configs/zero123.yaml", "zero123_refine", {2: UNET_ATTENTIONS}),
    "magic123": ("configs/zero123.yaml", "magic123", {2: 2 * UNET_ATTENTIONS}),
    "magic123_refine": ("configs/zero123.yaml", "magic123_refine", {2: 2 * UNET_ATTENTIONS}),
    "dreamfusion_if": ("configs/dreamfusion.yaml", "if", {2: UNET_ATTENTIONS}),
    "dreamfusion_if_perp_neg": ("configs/dreamfusion.yaml", "if_perp_neg",
                                {4: UNET_ATTENTIONS}),
}
# the VSD phase, a step: the pretrained CFG pass and the LoRA branch's camera
# CFG pass (B = 2 each), the regression (B = 1) and its backward
ZERO123_VSD_PER_STEP = {"fwd_by_batch": {2: 2 * UNET_ATTENTIONS, 1: UNET_ATTENTIONS},
                        "dq": UNET_ATTENTIONS, "dkv": UNET_ATTENTIONS}
# (N, M, H) of every attention of the Zero123 UNet at 32^2 latents (its
# 256^2 input): self-attention at 32^2, 16^2, 8^2 tokens and the 4^2 mid
# block, and cross-attention to the one CLIP image token at each
ZERO123_ATTN_SHAPES = [(1024, 1024, 5), (256, 256, 10), (64, 64, 20), (16, 16, 20),
                       (1024, 1, 5), (256, 1, 10), (64, 1, 20), (16, 1, 20)]


def single_image_argv(work: str, device: str, size: str, run: str, steps: int, png: str,
                      res: Optional[int] = None) -> list:
    """``launch_torch.py --train`` of run ``run`` of ``SINGLE_IMAGE_RUNS``:
    random weights (bf16 at full width), ``steps`` steps with the occupancy
    refresh every 2, 1 test view, the isosurface export at level 5; the
    input image ``png`` with its depth and normal side files; ``res``
    replaces Zero123's render size."""
    config, kind, _ = SINGLE_IMAGE_RUNS[run]
    tiny = size == "tiny"
    argv = ["--config", config, "--train", "--device", device, "data.n_test_views=1",
            f"trainer.max_steps={steps}", "trainer.val_check_interval=0",
            "checkpoint.every_n_train_steps=0", f"exp_root_dir={work}/runs_{run}",
            "use_timestamp=false", "system.renderer.grid_update_every=2"]
    if kind.startswith("if"):
        argv += ["system.guidance_type=deep-floyd-guidance",
                 "system.guidance!={model_size: %s, half_precision_weights: %s, "
                 "guidance_scale: 20.0, cache_dir: null%s}" % (
                     ("tiny", "false", ", resolution: 16") if tiny else ("if", "true", "")),
                 "system.prompt_processor_type=deep-floyd-prompt-processor",
                 _SD_PROMPT % ("tiny" if tiny else "sd21"),
                 f"system.geometry.isosurface_threshold={VOLUME_ISO_LEVEL}"]
        if kind == "if_perp_neg":
            argv.append("system.prompt_processor.use_perp_neg=true")
        return argv + ([a for a in VOLUME_TINY if "guidance" not in a and "prompt" not in a]
                       if tiny else [])
    refine = kind.endswith("refine")
    prompted = kind in ("icdf", "magic123", "magic123_refine")
    side = (16 if tiny else (SINGLE_IMAGE_REFINE_RES if refine else SINGLE_IMAGE_SD_RES
                             if prompted else res or SINGLE_IMAGE_RES))
    argv += [f"data.image_path={png}", "data.requires_depth=true", "data.requires_normal=true",
             "system.loss.lambda_depth=0.05", "system.loss.lambda_normal=0.1",
             f"data.width={side}", f"data.height={side}"]
    z123 = (_Z123_TINY if tiny else _Z123_FULL) % png
    if kind == "simple":
        argv.append("system_type=zero123-simple-system")
    if kind == "icdf":
        argv.append("system_type=image-condition-dreamfusion-system")
    if kind.startswith("magic123"):
        argv += ["system_type=magic123-system", f"system.guidance_3d!={z123}", _MAGIC123_LOSS]
    if prompted:
        argv += ["system.guidance_type=stable-diffusion-guidance", _SD_BLOCK[size],
                 _SD_PROMPT % ("tiny" if tiny else "sd21"),
                 "system.renderer.return_normal_perturb=false"]
    else:
        argv.append(f"system.guidance!={z123}")
    if refine:
        argv += [_DMTET[0], _DMTET[1] % (12 if tiny else 128), _DMTET[2]]
        argv += ["system.loss.lambda_normal_consistency=1000.0"] if kind == "zero123_refine" \
            else []
        if tiny:
            argv += ["system.geometry.max_crossing_tets=2048",
                     "system.renderer.sdf_opacity_samples=8",
                     "system.renderer.eval_chunk_rays=256"]
    else:
        argv.append(f"system.geometry.isosurface_threshold={VOLUME_ISO_LEVEL}")
        argv += SINGLE_IMAGE_TINY if tiny else []
    return argv


def write_input_image(path: str, res: int, device: str, torus=(192, 96)) -> dict:
    """The input image of path 10: the torus of main path 3 (R 0.7, r 0.28),
    its axis turned to +x and scaled by 0.6, seen from Zero123's reference
    camera (``configs/zero123.yaml``: elevation 0, azimuth 0, distance 3.8,
    fovy 20) at ``res``^2 through ``cast_rays_dense`` (kernel B on the
    card): ``path`` (RGBA, a Lambert shade of a warm albedo, alpha the
    hits), its ``_depth.png`` (nearer is brighter) and ``_normal.png``
    ((n + 1) / 2). Returns the hit share and the cast's seconds."""
    from PIL import Image

    from dreammat_tpu_torch.models.mesh import torus_arrays
    from dreammat_tpu_torch.ops import bvh as bvh_lib
    from dreammat_tpu_torch.utils import ops as uops

    v, f = torus_arrays(0.7, 0.28, *torus)
    v = (np.stack([v[:, 2], v[:, 1], -v[:, 0]], axis=-1) * 0.6).astype(np.float32)
    bvh = bvh_lib.build_bvh(v, f, device=device)
    pos = torch.tensor([[3.8, 0.0, 0.0]], device=device)
    c2w = uops.get_c2w(pos, torch.zeros(1, 3, device=device),
                       torch.tensor([[0.0, 0.0, 1.0]], device=device))[0]
    focal = 0.5 * res / np.tan(0.5 * np.deg2rad(20.0))
    dirs = uops.get_ray_directions(res, res, float(focal), device=device)
    ro, rd = uops.get_rays(dirs, c2w)
    t0 = time.time()
    hits = bvh_lib.cast_rays_dense(bvh, ro.contiguous(), rd.contiguous())
    if device != "cpu":
        torch.cuda.synchronize()
    cast_s = time.time() - t0
    hit = hits["hit"].cpu().numpy()
    face = np.clip(hits["face"].cpu().numpy(), 0, None)
    vt = torch.as_tensor(v)
    e1 = vt[f[:, 1]] - vt[f[:, 0]]
    e2 = vt[f[:, 2]] - vt[f[:, 0]]
    n = torch.nn.functional.normalize(torch.linalg.cross(e1, e2), dim=-1).numpy()[face]
    n = np.where((n * rd.cpu().numpy()).sum(-1, keepdims=True) > 0, -n, n)
    light = np.asarray([0.6, 0.3, 0.75]) / np.linalg.norm([0.6, 0.3, 0.75])
    shade = 0.25 + 0.75 * np.clip((n * light).sum(-1, keepdims=True), 0, 1)
    rgb = np.asarray([0.85, 0.45, 0.25]) * shade
    m = hit[:, None]
    to8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8).reshape(res, res, -1)
    t = hits["t"].cpu().numpy()
    depth = np.where(hit, 1.0 - (t - t[hit].min()) / max(np.ptp(t[hit]), 1e-6) * 0.8, 0.0)
    Image.fromarray(to8(np.concatenate([rgb * m + (1 - m), m], -1)), "RGBA").save(path)
    Image.fromarray(to8(depth[:, None])[..., 0], "L").save(path.replace("_rgba", "_depth"))
    Image.fromarray(to8((n + 1) / 2 * m), "RGB").save(path.replace("_rgba", "_normal"))
    return {"res": res, "hit_share": float(hit.mean()), "cast_s": cast_s, "triangles": len(f)}


def conditioning_vs_cpu(guidance) -> dict:
    """Zero123's conditioning of the input image in fp32, on the card and on
    the CPU from copies of the run's (bf16) image tower and VAE: max |diff| of
    the CLIP token and of the unscaled ``c_concat``, relative to their
    largest values (at most 1e-3: fp32 with TF32 off on the card)."""
    import copy

    res = {}
    for device in ("cuda", "cpu"):
        vision = copy.deepcopy(guidance.vision).float().to(device)
        vae = copy.deepcopy(guidance.vae).float().to(device)
        cond = guidance.cond_rgb.float().to(device)
        with torch.no_grad():
            res[device] = (vision(cond).cpu(), vae.encode_moments(cond * 2.0 - 1.0)[0].cpu())
        del vision, vae
    out = {}
    for i, key in enumerate(("c_crossattn", "c_concat")):
        a, b = res["cuda"][i], res["cpu"][i]
        out[key] = float((a - b).abs().max() / b.abs().max())
        out[key + "_shape"] = list(b.shape)
    if not max(out["c_crossattn"], out["c_concat"]) <= 1e-3:
        raise AssertionError(f"Zero123 conditioning, card against the CPU: {out}")
    return out


def zero123_vsd_phase(device: str, size: str, steps: int, png: str) -> dict:
    """``zero123-vsd-guidance`` at full width (no system drives it): ``steps``
    AdamW steps (lr 1e-3) of the LoRA state on ``loss_lora`` plus
    ``loss_vsd``'s image gradient on a 64^2 image, the camera the random
    view's c2w. The LoRA factors (up and down) and the camera embedding must
    move, the frozen UNet must not (per-tensor checksums), the image's
    gradient must be finite and non-zero; on the card kernel A by batch and
    C and D exactly ``ZERO123_VSD_PER_STEP`` a step."""
    import dreammat_tpu_torch
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.utils import ops as uops
    from dreammat_tpu_torch.utils.rng import TorchDraws

    tiny = size == "tiny"
    g = dreammat_tpu_torch.find("zero123-vsd-guidance")(
        {"model_size": "tiny" if tiny else "zero123", "half_precision_weights": not tiny,
         "cache_dir": None, "cond_image_path": png, "cond_camera_distance": 3.8,
         "width": 24 if tiny else 256, "height": 24 if tiny else 256, "lora_rank": 4,
         "lora_cfg_training": True, "guidance_scale": 3.0}, device=device)
    g.init_params(torch.Generator(device=device).manual_seed(0))
    lora = g.init_lora(torch.Generator(device=device).manual_seed(1))
    lora0 = {n: p.detach().clone() for n, p in lora.named_parameters()}
    unet_sums = {n: tensor_checksum(p) for n, p in g.unet.named_parameters()}
    opt = torch.optim.AdamW(lora.parameters(), lr=1e-3)
    draws = TorchDraws(0, device)
    elev, azim, dist = (torch.tensor([x], device=device) for x in (20.0, 60.0, 3.8))
    c2w = uops.get_c2w(uops.camera_position_from_spherical(elev, azim, dist).to(device))
    img = torch.rand(1, 3, 64, 64, generator=torch.Generator(device=device).manual_seed(2),
                     device=device).requires_grad_(True)
    kernels = (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
               attn.flash_attention_bwd_dkv)
    for fn in kernels:
        fn.launches = 0
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    step_s, losses = [], []
    with AttentionBatches() as batches:
        for step in range(steps):
            t0 = time.time()
            opt.zero_grad(set_to_none=True)
            img.grad = None
            out = g(img, elev, azim, dist, c2w=c2w, lora=lora, step=step, draws=draws)
            (out["loss_vsd"] + out["loss_lora"]).backward()
            opt.step()
            sync()
            step_s.append(time.time() - t0)
            losses.append((float(out["loss_vsd"].detach()), float(out["loss_lora"].detach())))
    moved = {n: (p.detach() - lora0[n]).abs().max().item() for n, p in lora.named_parameters()}
    r = {"steps": steps, "step_s": step_s, "losses": losses,
         "launches": {"flash_attn_fwd": kernels[0].launches,
                      "flash_attn_bwd_dq": kernels[1].launches,
                      "flash_attn_bwd_dkv": kernels[2].launches},
         "flash_attn_fwd_by_batch": dict(batches.counts),
         "lora_moved": {"up": max(v for n, v in moved.items() if n.endswith(".up")),
                        "down": max(v for n, v in moved.items() if n.endswith(".down")),
                        "camera_embedding": max(v for n, v in moved.items()
                                                if n.startswith("camera_embedding"))},
         "unet_changed": sum(tensor_checksum(p) != unet_sums[n]
                             for n, p in g.unet.named_parameters()),
         "image_grad_max": float(img.grad.abs().max())}
    if not (all(math.isfinite(a) and math.isfinite(b) for a, b in losses)
            and min(r["lora_moved"].values()) > 0 and r["unet_changed"] == 0
            and 0 < r["image_grad_max"] < float("inf")):
        raise AssertionError(f"path 10 zero123 VSD: {r}")
    want = ZERO123_VSD_PER_STEP
    want_fwd = {b: k * steps for b, k in want["fwd_by_batch"].items()}
    if device != "cpu" and (r["flash_attn_fwd_by_batch"] != want_fwd
                            or r["launches"]["flash_attn_bwd_dq"] != want["dq"] * steps
                            or r["launches"]["flash_attn_bwd_dkv"] != want["dkv"] * steps):
        raise AssertionError(f"path 10 zero123 VSD: kernel A by batch "
                             f"{r['flash_attn_fwd_by_batch']} (expected {want_fwd}), launches "
                             f"{r['launches']}")
    log(f"single_image zero123 VSD guidance ({'tiny' if tiny else 'Zero123 width, bf16'}): "
        f"steps {', '.join(f'{x:.4f}s' for x in step_s)}; kernel A by batch "
        f"{r['flash_attn_fwd_by_batch']}, C {r['launches']['flash_attn_bwd_dq']}, D "
        f"{r['launches']['flash_attn_bwd_dkv']}; LoRA moved {r['lora_moved']}, frozen UNet "
        f"tensors changed {r['unet_changed']}; image grad max {r['image_grad_max']:.3e}; losses "
        f"(vsd, lora) {losses}")
    return r


def single_image_breakdown(system, dm, step: int) -> dict:
    """CUDA-event ms of a training step's parts on a fresh batch of the
    trained scene: the render (the reference and the random view in one
    call for the single-image systems) forward and backward, and each
    guidance on the random view's image, forward and the backward of its
    loss into the image."""
    from dreammat_tpu_torch.models.volume_renderer import PrefixedDraws
    from dreammat_tpu_torch.systems.dreamfusion import as_image
    from dreammat_tpu_torch.systems.zero123 import render_ref_and_random
    from dreammat_tpu_torch.utils.rng import TorchDraws

    batch = dm.collate(step=step)
    if type(system).__name__ == "Zero123Simple":  # it renders the random view alone
        batch = batch["random_camera"]
    draws = TorchDraws(step, system.device)
    params = list(system.field.parameters())
    single = "random_camera" in batch
    rc = batch["random_camera"] if single else batch

    def render():
        out = (render_ref_and_random(system, batch, draws)[1] if single
               else system.render_batch(batch, draws, True, **system.train_render_kw()))
        (out["comp_rgb"].float().sum() + out["opacity"].sum()).backward()
        for p in params:
            p.grad = None
        return out

    with torch.no_grad():
        out = render_ref_and_random(system, batch, draws)[1] if single \
            else system.render_batch(batch, draws, False)
    img = as_image(out["comp_rgb"], rc).detach().requires_grad_(True)
    view = (rc["elevation"], rc["azimuth"], rc["camera_distances"])
    res = {"render": cuda_ms(render, 3)}
    for name in ("guidance", "guidance_3d"):
        g = getattr(system, name, None)
        if g is None:
            continue
        if hasattr(g, "cc_w"):  # Zero123: no prompts
            call = lambda g=g: g(img, *view, step=step, draws=PrefixedDraws(draws, name))
        else:
            call = lambda g=g: g(img, system.prompt_utils, *view, None, step=step, draws=draws)
        res[name] = cuda_ms(lambda call=call: call()["loss_sds"].backward(), 3)
    return res


def drive_single_image(work: str, device: str = "cuda", size: str = "sd21", steps: int = 3,
                       runs=None) -> dict:
    """Main path 10 through ``launch_torch.py --train`` of each run of
    ``SINGLE_IMAGE_RUNS`` (``single_image_argv``) on the input image of
    ``write_input_image`` (made at ``SINGLE_IMAGE_INPUT_RES``^2 through kernel
    B): Zero123 (``configs/zero123.yaml`` as written, accumulate mode, with
    the depth and normal side files), ``zero123-simple-system``,
    ``image-condition-dreamfusion-system`` (SD2.1 guidance), Zero123's
    refinement (DMTet at 128, the rasterizer, 512^2), Magic123's volume
    stage and its refinement (SD2.1 and Zero123 on each view), and
    DreamFusion-IF (``configs/dreamfusion.yaml`` with ``deep-floyd-guidance``
    and the T5-XXL prompt processor; once with Perp-Neg), at full width with
    random weights, ``steps`` steps each, 1 test view; then the
    ``zero123-vsd-guidance`` phase (``zero123_vsd_phase``). Per run: finite
    losses and parameters, the field moved (checksums), the test PNG and
    ``model.obj`` with faces. On the card also kernel A exactly the run's
    launches a step by batch, C and D none, kernel B one launch a
    refinement step and one an eval chunk (none in the volume runs); for
    Zero123's volume run 2048 eval rays card against CPU within 2e-3 and
    the conditioning card against CPU in fp32, and every run's render and
    guidance ms (``single_image_breakdown``). Each run's first and warm
    step seconds, peak memory and test-view seconds. ``runs`` picks runs
    (``"vsd"`` the VSD phase). Returns each run's numbers; raises on a
    failed check."""
    import shutil

    import launch_torch
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    png = os.path.join(work, "ring_rgba.png")
    tiny = size == "tiny"
    res_input = write_input_image(png, 48 if tiny else SINGLE_IMAGE_INPUT_RES, device,
                                  torus=(24, 12) if tiny else (192, 96))
    if not 0.05 < res_input["hit_share"] < 0.9:
        raise AssertionError(f"path 10 input image: {res_input}")
    counters = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv,
                "ray_cast": bvh_lib.cast_rays_dense}
    out_res = {"input_image": res_input, "runs": {}}
    for run in [r for r in (runs or SINGLE_IMAGE_RUNS) if r != "vsd"]:
        config, kind, per_step = SINGLE_IMAGE_RUNS[run]
        for fn in counters.values():
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with AttentionBatches() as batches:
            out = launch_torch.main(single_image_argv(work, device, size, run, steps, png))
        sync()
        system, trial, cfg, dm = out["system"], out["trial_dir"], out["cfg"], out["datamodule"]
        step_s = list(system.step_seconds)
        field = system.field
        r = {"seconds": time.time() - t0, "system": type(system).__name__,
             "guidance": type(system.guidance).__name__,
             "renderer": type(system.renderer).__name__,
             "geometry": type(system.geometry).__name__,
             "render_hw": [dm.cfg.height, dm.cfg.width],
             "launches": {k: fn.launches for k, fn in counters.items()},
             "flash_attn_fwd_by_batch": dict(batches.counts),
             "step_s": step_s, "first_step_s": step_s[0],
             "warm_step_s": float(np.mean(step_s[1:] or step_s)),
             "test_s": list(system.test_seconds), "losses": list(system.step_losses),
             "step_peak_gb": list(system.step_peak_gb),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        if getattr(system, "guidance_3d", None) is not None:
            r["guidance_3d"] = type(system.guidance_3d).__name__
        if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"path 10 {run}: losses {r['losses']}")
        if not all(torch.isfinite(p).all() for p in field.parameters()):
            raise AssertionError(f"path 10 {run}: a parameter is not finite")
        save = os.path.join(trial, "save")
        r["test_png"] = check_file(os.path.join(save, f"it{steps}-test", "0.png"),
                                   b"\x89PNG\r\n\x1a\n", 100)
        with open(os.path.join(save, "export", "model.obj")) as f:
            lines = f.read().splitlines()
        r["obj_v"] = sum(ln.startswith("v ") for ln in lines)
        r["obj_f"] = sum(ln.startswith("f ") for ln in lines)
        if not (r["obj_v"] > 0 and r["obj_f"] > 0):
            raise AssertionError(f"path 10 {run}: model.obj has {r['obj_v']} v, {r['obj_f']} f")
        if cuda:
            want = {b: n * steps for b, n in per_step.items()}
            n_eval = dm.cfg.n_test_views * math.ceil(
                dm.inner.cfg.eval_height * dm.inner.cfg.eval_width
                / getattr(system.renderer.cfg, "eval_chunk_rays", 1)) \
                if kind.endswith("refine") else 0
            want_b = steps + n_eval if kind.endswith("refine") else 0
            if (r["flash_attn_fwd_by_batch"] != want or r["launches"]["ray_cast"] != want_b
                    or r["launches"]["flash_attn_bwd_dq"] or r["launches"]["flash_attn_bwd_dkv"]):
                raise AssertionError(f"path 10 {run}: kernel A by batch "
                                     f"{r['flash_attn_fwd_by_batch']} (expected {want}), "
                                     f"launches {r['launches']} (kernel B expected {want_b})")
            if run == "zero123":
                r["render_vs_cpu"] = volume_render_vs_cpu(system, dm, cfg)
                r["conditioning_vs_cpu"] = conditioning_vs_cpu(system.guidance)
            r["step_ms"] = single_image_breakdown(system, dm, steps)
            r["render_share"] = r["step_ms"]["render"] / (1e3 * r["warm_step_s"])
        log(f"single_image {run} ({r['system']}, {r['guidance']}"
            + (f" + {r['guidance_3d']}" if "guidance_3d" in r else "")
            + f", {r['geometry']}, {r['renderer']}, {r['render_hw'][0]}^2 renders): "
            f"launch_torch.py --train in {r['seconds']:.1f}s; kernel A by batch "
            f"{r['flash_attn_fwd_by_batch']}, launches {r['launches']}; steps "
            f"{', '.join(f'{x:.4f}s' for x in step_s)} (first {r['first_step_s']:.4f}s, warm "
            f"{r['warm_step_s']:.4f}s), peak {', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])}"
            f" (run {r['peak_gb'] or 0:.2f} GB); test view "
            f"{', '.join(f'{x:.3f}s' for x in r['test_s'])}; model.obj {r['obj_v']} v, "
            f"{r['obj_f']} f; losses {', '.join(f'{x:.6g}' for x in r['losses'])}"
            + (f"; step parts ms {r['step_ms']} (render {100 * r['render_share']:.1f}% of the "
               f"warm step)" if "step_ms" in r else "")
            + (f"; {r['render_vs_cpu']['rays']} eval rays card vs CPU: comp_rgb "
               f"{r['render_vs_cpu']['comp_rgb']:.2e}, opacity {r['render_vs_cpu']['opacity']:.2e}"
               f", depth (relative) {r['render_vs_cpu']['depth']:.2e}; conditioning card vs CPU "
               f"{r['conditioning_vs_cpu']}" if "render_vs_cpu" in r else ""))
        out_res["runs"][run] = r
        del out, system, field, dm
        if cuda:
            torch.cuda.empty_cache()
    if runs is None or "vsd" in runs:
        out_res["zero123_vsd"] = zero123_vsd_phase(device, size, steps, png)
    return out_res


def phase_single_image() -> dict:
    """Main path 10 on the card (``drive_single_image`` at full width)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_single_image")
    res_out = drive_single_image(work)
    keys = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "ray_cast")
    res_out["counts"] = {k: sum(r["launches"][k] for r in res_out["runs"].values())
                         + res_out["zero123_vsd"]["launches"].get(k, 0) for k in keys}
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res_out


EDIT_PROMPT = "turn it into glazed blue porcelain"
# the capture: the torus of main path 3 on a ring of cameras (distance,
# elevation in degrees, vertical field of view in degrees)
EDIT_RING = (2.5, 20.0, 40.0)
EDIT_CAPTURE = {"sd21": (256, 24, (192, 96)), "tiny": (32, 8, (24, 12))}
# the IP2P guidance at full width (bf16, 512^2 edits: the UNet sees its own
# 64^2 latents, 20 DDIM steps) and at the CPU's tiny size
IP2P_DDIM_STEPS = 20
IP2P_BLOCK = {"sd21": "{model_size: ip2p, half_precision_weights: true, fixed_size: 512, "
                      f"diffusion_steps: {IP2P_DDIM_STEPS}, cache_dir: null}}",
              "tiny": "{model_size: tiny, half_precision_weights: false, fixed_size: 16, "
                      "diffusion_steps: 2, cache_dir: null}"}
# kernel A's launches: each DDIM step of an edit and each SDS step is one
# UNet pass of the three CFG replicas
EDIT_PER_EDIT = {3: IP2P_DDIM_STEPS * UNET_ATTENTIONS}
IP2P_SDS_PER_STEP = {3: UNET_ATTENTIONS}
# per run: (system, steps, datamodule block, extra overrides)
EDIT_RUNS = ("instructnerf2nerf", "control4d")
EDIT_STEPS = {"instructnerf2nerf": 3, "control4d": 6}
IN2N_LOSS = ("system.loss!={lambda_l1: 10.0, lambda_p: 10.0, lambda_orient: 0.0, "
             "lambda_sparsity: 0.0, lambda_opaque: 0.0}")
C4D_LOSS = ("system.loss!={lambda_l1: 10.0, lambda_p: 10.0, lambda_G: 1.0, lambda_kl: 1.0e-6, "
            "lambda_D: 1.0, lambda_orient: 0.0, lambda_sparsity: 0.0, lambda_opaque: 0.0}")
# the GAN renderer at the JAX defaults (ch 64, local 32, ch_mult (1, 2, 4),
# global 64, PatchGAN 64 x 3) over configs/dreamfusion.yaml's NeRF renderer
C4D_RENDERER = ("system.renderer!={base_renderer_type: nerf-volume-renderer, base_renderer: "
                "{radius: 2.0, num_samples_per_ray: %d, estimator: occgrid, grid_resolution: %d, "
                "grid_update_every: 2%s}%s}")
# configs/dreamfusion.yaml's field cut to the CPU tiny form
EDIT_TINY = [
    "system.geometry.pos_encoding_config.n_levels=4",
    "system.geometry.pos_encoding_config.log2_hashmap_size=10",
    "system.geometry.pos_encoding_config.base_resolution=4",
    "system.geometry.pos_encoding_config.per_level_scale=1.5",
    "system.geometry.isosurface_resolution=24",
]


def write_capture(root: str, size: str, device: str) -> dict:
    """Main path 11's capture: the torus of main path 3 (R 0.7, r 0.28) cast
    through ``cast_rays_dense`` (kernel B on the card) from a ring of
    cameras looking at the origin (``EDIT_RING``), at ``EDIT_CAPTURE``'s
    resolution: a Lambert shade of a banded warm albedo over white, the hit
    mask and the z-depth. Written twice: as a nerfstudio capture
    (``<root>/multiview/transforms.json``, OPENCV c2w and intrinsics,
    ``images/``) and as one CO3D sequence (``<root>/co3d/torus/ring/`` with
    ``images/``, ``masks/`` and 16-bit float depth PNGs, and
    ``<root>/co3d/torus/frame_annotations.jgz`` with PyTorch3D cameras in
    the v2 NDC-isotropic convention), the layout ``tests/test_co3d.py``
    writes. Returns the paths, the hit share and the casts' seconds."""
    import gzip

    from PIL import Image

    from dreammat_tpu_torch.models.mesh import torus_arrays
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    res, n_cams, torus = EDIT_CAPTURE[size]
    dist, elev, fovy = EDIT_RING
    v, f = torus_arrays(0.7, 0.28, *torus)
    bvh = bvh_lib.build_bvh(v, f, device=device)
    fl = 0.5 * res / np.tan(0.5 * np.deg2rad(fovy))
    px = np.arange(res, dtype=np.float32) + 0.5
    i, j = np.meshgrid(px, px, indexing="xy")
    dirs_cam = np.stack([(i - res / 2) / fl, (j - res / 2) / fl, np.ones_like(i)], -1)
    light = np.asarray([0.6, 0.3, 0.75]) / np.linalg.norm([0.6, 0.3, 0.75])
    n_face = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n_face /= np.linalg.norm(n_face, axis=-1, keepdims=True)
    band = 0.7 + 0.3 * ((f[:, 0] // (torus[1] * 8)) % 2)  # rings of 8 segments
    mv, co3d = os.path.join(root, "multiview"), os.path.join(root, "co3d")
    seq = os.path.join(co3d, "torus", "ring")
    for d in (os.path.join(mv, "images"), *(os.path.join(seq, s)
                                             for s in ("images", "masks", "depths"))):
        os.makedirs(d, exist_ok=True)
    cam_trans = np.diag(np.array([-1, -1, 1, 1], np.float32))
    frames, annotations, hit_share, cast_s = [], [], [], 0.0
    for k in range(n_cams):
        a = 2 * np.pi * k / n_cams
        pos = dist * np.array([np.cos(np.deg2rad(elev)) * np.cos(a),
                               np.cos(np.deg2rad(elev)) * np.sin(a), np.sin(np.deg2rad(elev))])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)  # OPENCV: x right, y down, z forward
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, -np.cross(right, fwd), fwd, pos
        rd = (dirs_cam @ c2w[:3, :3].T).reshape(-1, 3)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        ro = np.broadcast_to(c2w[:3, 3], rd.shape)
        t0 = time.time()
        hits = bvh_lib.cast_rays_dense(bvh, torch.tensor(ro, dtype=torch.float32, device=device),
                                       torch.tensor(rd, dtype=torch.float32, device=device))
        if device != "cpu":
            torch.cuda.synchronize()
        cast_s += time.time() - t0
        hit = hits["hit"].cpu().numpy()
        face = np.clip(hits["face"].cpu().numpy(), 0, None)
        nrm = n_face[face] * np.where((n_face[face] * rd).sum(-1, keepdims=True) > 0, -1, 1)
        shade = 0.3 + 0.7 * np.clip((nrm * light).sum(-1, keepdims=True), 0, 1)
        rgb = np.where(hit[:, None], np.asarray([0.85, 0.5, 0.3]) * band[face, None] * shade, 1.0)
        depth = np.where(hit, hits["t"].cpu().numpy() * (rd @ fwd), 0.0).astype(np.float16)
        hit_share.append(float(hit.mean()))
        to8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)
        name = f"frame{k:03d}.png"
        img = Image.fromarray(to8(rgb).reshape(res, res, 3))
        img.save(os.path.join(mv, "images", name))
        img.save(os.path.join(seq, "images", name))
        Image.fromarray(to8(hit.astype(np.float32)).reshape(res, res)).save(
            os.path.join(seq, "masks", name))
        Image.fromarray(np.frombuffer(depth.tobytes(), np.uint16).reshape(res, res)).save(
            os.path.join(seq, "depths", name))
        frames.append({"file_path": f"images/{name}", "transform_matrix": c2w.tolist(),
                       "w": res, "h": res, "fl_x": fl, "fl_y": fl, "cx": res / 2,
                       "cy": res / 2})
        p3d = c2w @ cam_trans  # OpenCV -> PyTorch3D (cam_trans is its own inverse)
        R = p3d[:3, :3]
        rel = lambda s: f"torus/ring/{s}/{name}"
        annotations.append({
            "sequence_name": "ring", "frame_number": k, "meta": {"frame_type": "train"},
            "image": {"path": rel("images"), "size": [res, res]}, "mask": {"path": rel("masks")},
            "depth": {"path": rel("depths"), "scale_adjustment": 1.0},
            "viewpoint": {"focal_length": [fl / (res / 2)] * 2, "principal_point": [0.0, 0.0],
                          "R": R.tolist(), "T": (-np.linalg.inv(R) @ p3d[:3, 3]).tolist()}})
    with open(os.path.join(mv, "transforms.json"), "w") as fh:
        json.dump({"camera_model": "OPENCV", "frames": frames}, fh)
    with gzip.open(os.path.join(co3d, "torus", "frame_annotations.jgz"), "wt") as fh:
        json.dump(annotations, fh)
    return {"multiview": mv, "co3d": seq, "res": res, "cameras": n_cams,
            "triangles": len(f), "hit_share": float(np.mean(hit_share)), "cast_s": cast_s}


def edit_argv(work: str, device: str, size: str, run: str, steps: int, capture: dict) -> list:
    """``launch_torch.py --train`` of ``configs/dreamfusion.yaml`` as run
    ``run`` of ``EDIT_RUNS``: random weights, the IP2P guidance and its
    768-wide text tower (``model_size: ip2p``), ``steps`` steps with the
    occupancy refresh every 2, 1 test view, the isosurface export at level
    ``VOLUME_ISO_LEVEL``. Instruct-NeRF2NeRF on the multiview capture at a
    quarter of its resolution (64^2 frames; the CPU's half: 16^2), an edit
    from step 1 on; Control4D on the CO3D sequence at the datamodule's
    defaults (256^2 frames), the hybrid RGB-latent material (3 + 8
    channels) over a solid background, the GAN renderer, an edit every
    step."""
    tiny = size == "tiny"
    argv = ["--config", "configs/dreamfusion.yaml", "--train", "--device", device,
            "system.guidance_type=stable-diffusion-instructpix2pix-guidance",
            f"system.guidance!={IP2P_BLOCK[size]}",
            "system.prompt_processor!={model_size: %s, prompt: %s, use_cache: false}" % (
                "tiny" if tiny else "ip2p", EDIT_PROMPT),
            f"trainer.max_steps={steps}", "trainer.val_check_interval=0",
            "checkpoint.every_n_train_steps=0", f"exp_root_dir={work}/runs_{run}",
            "use_timestamp=false", "system.per_editing_step=1",
            f"system.geometry.isosurface_threshold={VOLUME_ISO_LEVEL}"]
    S, G = (32, 8) if tiny else (512, 32)
    if run == "instructnerf2nerf":
        argv += ["system_type=instructnerf2nerf-system",
                 "data_type=multiview-camera-datamodule",
                 "data!={dataroot: %s, train_downsample_resolution: %d, n_test_views: 1}" % (
                     capture["multiview"], 2 if tiny else 4),
                 "system.start_editing_step=0", IN2N_LOSS,
                 "system.renderer.grid_update_every=2"]
        if tiny:
            argv += [f"system.renderer.num_samples_per_ray={S}",
                     f"system.renderer.grid_resolution={G}", "system.renderer.eval_chunk_rays=256"]
    else:
        eval_hw = ", random_camera: {eval_height: 32, eval_width: 32}" if tiny else ""
        argv += ["system_type=control4d-multiview-system", "data_type=co3d-datamodule",
                 "data!={root_dir: %s, n_test_views: 1%s%s}" % (
                     capture["co3d"], ", height: 32, width: 32" if tiny else "", eval_hw),
                 "system.start_editing_step=-1", C4D_LOSS,
                 "system.geometry.n_feature_dims=11",
                 "system.material_type=hybrid-rgb-latent-material",
                 "system.material!={n_output_dims: 11}",
                 "system.background_type=solid-color-background",
                 "system.background!={n_output_dims: 11}",
                 "system.renderer_type=gan-volume-renderer",
                 C4D_RENDERER % (S, G, ", eval_chunk_rays: 256" if tiny else "",
                                 ", ch: 16, local_ch: 8, global_dim: 16, disc_ndf: 16"
                                 if tiny else "")]
    return argv + (EDIT_TINY if tiny else [])


@contextlib.contextmanager
def plain_attention():
    """The diffusion models' attention through ``attention_plain`` inside:
    the fp32 comparisons of main path 11 run the UNet in fp32, which kernel
    A (bf16) does not take; kernel A is held against its plain version in
    the kernel phase."""
    from dreammat_tpu_torch.models.diffusion import layers
    from dreammat_tpu_torch.ops.attention import attention_plain

    real = layers.fused_attention
    layers.fused_attention = attention_plain
    try:
        yield
    finally:
        layers.fused_attention = real


def ip2p_eps_vs_cpu(guidance, prompt_utils, frame: torch.Tensor, seed: int = 0) -> dict:
    """The guided eps of an edit's first DDIM step at full width in fp32: the
    render's latent (``frame`` [1,H,W,3] resized to the guidance's size,
    encoded with a drawn posterior sample) noised to t = 500, the condition
    stack and the [pos, neg, neg] embeddings made by the run's guidance, then
    ``eps3`` through fp32 copies of the run's UNet on the card and on the
    CPU (attention plain in both). Max |diff| relative to max |eps|, at most
    1e-3 (TF32 off)."""
    import copy
    from types import SimpleNamespace

    from dreammat_tpu_torch.models.detectors import resize_linear
    from dreammat_tpu_torch.models.diffusion.scheduler import add_noise

    g, dev = guidance, guidance.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = g.cfg.fixed_size
    with torch.no_grad():
        img = resize_linear(frame.permute(0, 3, 1, 2), (s, s))
        lat_shape = (1, 4, s // g.vae_factor, s // g.vae_factor)
        latents = g.encode_images(img, torch.randn(lat_shape, generator=gen, device=dev))
        cond3 = g.cond_latents(img)
        t = torch.full((1,), 500, dtype=torch.long, device=dev)
        x = add_noise(g.schedule, latents, torch.randn(lat_shape, generator=gen, device=dev), t)
        zero = torch.zeros(1, device=dev)
        emb = prompt_utils.get_text_embeddings(zero, zero, zero, view_dependent_prompting=False,
                                               return_null=False)
        emb3 = torch.cat([emb, emb[1:]], dim=0)
        unet = copy.deepcopy(g.unet).float()
        eps = {}
        with plain_attention():
            eps["card"] = type(g).eps3(SimpleNamespace(unet=unet, cfg=g.cfg), x, cond3, t, emb3)
            unet = unet.cpu()
            cpu = lambda a: a.cpu()
            eps["cpu"] = type(g).eps3(SimpleNamespace(unet=unet, cfg=g.cfg), cpu(x), cpu(cond3),
                                      cpu(t), cpu(emb3))
    err = (eps["card"].cpu() - eps["cpu"]).abs().max().item()
    res = {"t": 500, "max_abs": eps["cpu"].abs().max().item(), "latent_hw": lat_shape[2]}
    res["rel_err"] = err / res["max_abs"]
    if not (math.isfinite(res["rel_err"]) and res["rel_err"] <= 1e-3):
        raise AssertionError(f"path 11 IP2P eps, card against the CPU in fp32: {res}")
    return res


def perceptual_vs_cpu(system, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The perceptual distance of a frame pair ([1,H,W,3] each) through the
    run's VGG16 tower on the card and a copy on the CPU, fp32: relative
    difference at most 1e-4."""
    import copy

    from dreammat_tpu_torch.utils.perceptual import perceptual_distance

    with torch.no_grad():
        card = perceptual_distance(system.vgg, a, b).item()
        cpu = perceptual_distance(copy.deepcopy(system.vgg).cpu(), a.cpu(), b.cpu()).item()
    res = {"card": card, "cpu": cpu, "rel_err": abs(card - cpu) / max(abs(cpu), 1e-12),
           "hw": list(a.shape[1:3])}
    if not (math.isfinite(card) and res["rel_err"] <= 1e-4):
        raise AssertionError(f"path 11 perceptual distance, card against the CPU: {res}")
    return res


def gan_render_vs_cpu(system, dm, cfg, n_rays: int = 2048) -> dict:
    """The GAN render of a 32 x 64 window (``n_rays`` rays) in the middle of
    eval view 0, by the trained scene and networks on the card and, from a
    copy, by the same system built on the CPU: max |diff| of the GAN image,
    the low-resolution image (upsampled) and the base opacity, at most 2e-3."""
    import copy

    import dreammat_tpu_torch

    batch = dm.eval_rays(0)
    H, W = batch["rays_o"].shape[:2]
    h, w = 32, n_rays // 32
    win = lambda x: x[H // 2 - h // 2:H // 2 + h // 2, W // 2 - w // 2:W // 2 + w // 2]
    ro, rd = win(batch["rays_o"]).reshape(-1, 3), win(batch["rays_d"]).reshape(-1, 3)
    lp = batch["light_position"].reshape(1, 3).expand_as(ro)
    cpu_sys = dreammat_tpu_torch.find(cfg.system_type)(cfg.system, device="cpu")
    field = copy.deepcopy(system.field).cpu()
    step = system.global_step
    with torch.no_grad():
        f = system.field
        card = system.renderer.render_rays(f.geo, f.bg, f.occ, ro, rd, lp, None, step=step,
                                           gan_nets=f.gan, height=h, width=w)
        cpu = cpu_sys.renderer.render_rays(field.geo, field.bg, field.occ, ro.cpu(), rd.cpu(),
                                           lp.cpu(), None, step=step, gan_nets=field.gan,
                                           height=h, width=w)
    res = {"rays": ro.shape[0], "hit_share": float((cpu["opacity"] > 0.5).float().mean())}
    for key in ("comp_gan_rgb", "comp_rgb", "opacity"):
        res[key] = (card[key].cpu() - cpu[key]).abs().max().item()
    if not max(res["comp_gan_rgb"], res["comp_rgb"], res["opacity"]) <= 2e-3:
        raise AssertionError(f"path 11 GAN render, card against the CPU: {res}")
    return res


def ip2p_sds_phase(device: str, size: str, steps: int, prompt_utils, frame: torch.Tensor,
                   seed: int = 0) -> dict:
    """The IP2P guidance alone in ``use_sds`` mode (at full width, bf16):
    ``steps`` AdamW steps (lr 0.01) of a 512^2 image (the CPU: 32^2) from
    the capture's frame, conditioned on that frame. Checks finite losses,
    the image moved, and on the card kernel A exactly ``IP2P_SDS_PER_STEP``
    a step, C and D none. Returns the step seconds, losses and launches."""
    import dreammat_tpu_torch
    from dreammat_tpu_torch.models.detectors import resize_linear
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.utils.rng import TorchDraws

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    block = {"model_size": "tiny", "half_precision_weights": False} if size == "tiny" else \
        {"model_size": "ip2p", "half_precision_weights": True}
    guidance = dreammat_tpu_torch.find("stable-diffusion-instructpix2pix-guidance")(
        {**block, "use_sds": True, "cache_dir": None}, device=device)
    guidance.init_params(torch.Generator(device=device).manual_seed(seed + 11))
    side = 32 if size == "tiny" else 512
    cond = resize_linear(frame.permute(0, 3, 1, 2), (side, side)).permute(0, 2, 3, 1)
    img = cond.clone().requires_grad_()
    opt = torch.optim.AdamW([img], lr=0.01)
    draws = TorchDraws(seed + 12, device)
    kernels = (attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv)
    for fn in kernels:
        fn.launches = 0
    losses, step_s = [], []
    with AttentionBatches() as batches:
        for it in range(steps):
            t0 = time.time()
            opt.zero_grad(set_to_none=True)
            out = guidance(img, cond, prompt_utils, step=it, draws=draws)
            out["loss_sds"].backward()
            opt.step()
            sync()
            step_s.append(time.time() - t0)
            losses.append(out["loss_sds"].item())
    res = {"hw": [side, side], "steps": steps, "step_s": step_s, "losses": losses,
           "image_moved": (img.detach() - cond).abs().max().item(),
           "flash_attn_fwd_by_batch": dict(batches.counts),
           "launches": {"flash_attn_fwd": sum(batches.counts.values()),
                        "flash_attn_bwd_dq": kernels[0].launches,
                        "flash_attn_bwd_dkv": kernels[1].launches}}
    if not (all(math.isfinite(x) for x in losses) and res["image_moved"] > 0):
        raise AssertionError(f"path 11 ip2p-sds: {res}")
    want = {b: n * steps for b, n in IP2P_SDS_PER_STEP.items()}
    if cuda and (res["flash_attn_fwd_by_batch"] != want or kernels[0].launches
                 or kernels[1].launches):
        raise AssertionError(f"path 11 ip2p-sds: kernel A by batch "
                             f"{res['flash_attn_fwd_by_batch']} (expected {want}), "
                             f"launches {res['launches']}")
    log(f"edit ip2p-sds ({side}^2 image, AdamW): steps "
        f"{', '.join(f'{x:.4f}s' for x in step_s)}; kernel A by batch "
        f"{res['flash_attn_fwd_by_batch']}, C {kernels[0].launches}, D {kernels[1].launches}; "
        f"losses {', '.join(f'{x:.6g}' for x in losses)}; image moved {res['image_moved']:.4g}")
    del guidance
    return res


def drive_edit(work: str, device: str = "cuda", size: str = "sd21") -> dict:
    """Main path 11, the editing family: the capture (``write_capture``,
    kernel B on the card), then ``launch_torch.main`` of each run of
    ``EDIT_RUNS`` (``edit_argv``): Instruct-NeRF2NeRF, 3 steps, and
    Control4D, 6 steps, at full width with random weights; then the
    ``ip2p-sds`` phase (``ip2p_sds_phase``, 3 steps). Per run: finite losses
    and parameters, the field (and Control4D's four networks) moved by
    checksums, the frames whose targets an edit replaced, the test PNG; for
    Control4D the generator levels drawn, each of 0, 1 and 2 at least once.
    On the card also kernel A exactly ``EDIT_PER_EDIT`` an edit and nothing
    at another batch, C, D and B none in the runs; 2048 eval rays card
    against CPU within 2e-3 (``volume_render_vs_cpu``,
    ``gan_render_vs_cpu``); for Instruct-NeRF2NeRF the perceptual distance
    of a frame and its edit (``perceptual_vs_cpu``) and the first DDIM
    step's eps (``ip2p_eps_vs_cpu``) card against CPU in fp32. Each run's
    first and warm step, edit seconds, peak memory and test-view seconds.
    Returns the numbers; raises on a failed check."""
    import shutil

    import launch_torch
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    bvh_lib.cast_rays_dense.launches = 0
    capture = write_capture(work, size, device)
    capture["ray_cast_launches"] = bvh_lib.cast_rays_dense.launches
    if not 0.05 < capture["hit_share"] < 0.9:
        raise AssertionError(f"path 11 capture: {capture}")
    counters = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv,
                "ray_cast": bvh_lib.cast_rays_dense}
    out_res = {"capture": capture, "runs": {}}
    prompt_utils = frame = None
    for run in EDIT_RUNS:
        steps = EDIT_STEPS[run]
        for fn in counters.values():
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with AttentionBatches() as batches:
            out = launch_torch.main(edit_argv(work, device, size, run, steps, capture))
        sync()
        system, trial, cfg, dm = out["system"], out["trial_dir"], out["cfg"], out["datamodule"]
        step_s = list(system.step_seconds)
        field = system.field
        first = dict(field.named_parameters())
        r = {"seconds": time.time() - t0, "system": type(system).__name__,
             "renderer": type(system.renderer).__name__,
             "render_hw": [dm.H, dm.W] if hasattr(dm, "H") else [dm.cfg.height, dm.cfg.width],
             "launches": {k: fn.launches for k, fn in counters.items()},
             "flash_attn_fwd_by_batch": dict(batches.counts), "edits": len(system.edit_seconds),
             "edit_s": list(system.edit_seconds), "edited_frames": sorted(system.edit_frames),
             "step_s": step_s, "first_step_s": step_s[0],
             "warm_step_s": float(np.mean(step_s[1:] or step_s)),
             "test_s": list(system.test_seconds), "losses": list(system.step_losses),
             "step_peak_gb": list(system.step_peak_gb),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        if getattr(system, "levels", None) is not None:
            r["levels"] = list(system.levels)
        if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"path 11 {run}: losses {r['losses']}")
        if not all(torch.isfinite(p).all() for p in first.values()):
            raise AssertionError(f"path 11 {run}: a parameter is not finite")
        if r["edits"] != steps - (run == "instructnerf2nerf") or not r["edited_frames"]:
            raise AssertionError(f"path 11 {run}: {r['edits']} edits, frames "
                                 f"{r['edited_frames']}")
        # the scene and each network moved from a fresh init with the run's seed
        system.init_state(cfg.seed)
        r["moved"] = {}
        for name, p in system.field.named_parameters():
            part = ".".join(name.split(".")[:2 if name.startswith("gan.") else 1])
            if tensor_checksum(p) != tensor_checksum(first[name]):
                r["moved"][part] = r["moved"].get(part, 0) + 1
        system.field = field
        want_parts = {"geo"} | ({"gan.generator", "gan.global_encoder", "gan.discriminator"}
                                if run == "control4d" else set())
        if not want_parts <= set(r["moved"]):
            raise AssertionError(f"path 11 {run}: moved tensors by part {r['moved']}")
        if run == "control4d" and set(r["levels"]) != {0, 1, 2}:
            raise AssertionError(f"path 11 control4d: generator levels {r['levels']}")
        r["test_png"] = check_file(os.path.join(trial, "save", f"it{steps}-test", "0.png"),
                                   b"\x89PNG\r\n\x1a\n", 100)
        if cuda:
            want = {b: n * r["edits"] for b, n in EDIT_PER_EDIT.items()}
            if (r["flash_attn_fwd_by_batch"] != want or r["launches"]["ray_cast"]
                    or r["launches"]["flash_attn_bwd_dq"] or r["launches"]["flash_attn_bwd_dkv"]):
                raise AssertionError(f"path 11 {run}: kernel A by batch "
                                     f"{r['flash_attn_fwd_by_batch']} (expected {want}), "
                                     f"launches {r['launches']}")
            if run == "instructnerf2nerf":
                r["render_vs_cpu"] = volume_render_vs_cpu(system, dm, cfg)
                idx = r["edited_frames"][0]
                a = dm.imgs[idx][None]
                r["perceptual_vs_cpu"] = perceptual_vs_cpu(system, a,
                                                           system.edit_frames[idx][None])
                r["eps_vs_cpu"] = ip2p_eps_vs_cpu(system.guidance, system.prompt_utils, a)
            else:
                r["render_vs_cpu"] = gan_render_vs_cpu(system, dm, cfg)
        log(f"edit {run} ({r['system']}, {r['renderer']}, {r['render_hw'][0]}^2 frames): "
            f"launch_torch.py --train in {r['seconds']:.1f}s; kernel A by batch "
            f"{r['flash_attn_fwd_by_batch']}, launches {r['launches']}; steps "
            f"{', '.join(f'{x:.4f}s' for x in step_s)} (first {r['first_step_s']:.4f}s, warm "
            f"{r['warm_step_s']:.4f}s); {r['edits']} edits of frames {r['edited_frames']} "
            f"({', '.join(f'{x:.3f}s' for x in r['edit_s'])}); peak "
            f"{', '.join(f'{x:.2f} GB' for x in r['step_peak_gb'])} (run {r['peak_gb'] or 0:.2f}"
            f" GB); test view {', '.join(f'{x:.3f}s' for x in r['test_s'])}; moved tensors "
            f"{r['moved']}; losses {', '.join(f'{x:.6g}' for x in r['losses'])}"
            + (f"; generator levels {r['levels']}" if "levels" in r else "")
            + (f"; card vs CPU: render {r['render_vs_cpu']}" if "render_vs_cpu" in r else "")
            + (f", perceptual {r['perceptual_vs_cpu']}, first DDIM eps (fp32) "
               f"{r['eps_vs_cpu']}" if "eps_vs_cpu" in r else ""))
        out_res["runs"][run] = r
        if run == "instructnerf2nerf":
            prompt_utils = system.prompt_utils
            frame = dm.imgs[0][None]
        del out, system, field, first, dm
        if cuda:
            torch.cuda.empty_cache()
    out_res["ip2p_sds"] = ip2p_sds_phase(device, size, 3, prompt_utils, frame)
    return out_res


def phase_edit() -> dict:
    """Main path 11 on the card (``drive_edit`` at full width)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_edit")
    res = drive_edit(work)
    keys = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "ray_cast")
    res["counts"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                     + res["ip2p_sds"]["launches"].get(k, 0) for k in keys}
    res["counts"]["ray_cast"] += res["capture"]["ray_cast_launches"]
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# main path 12: more than one process (torch.distributed)
# ---------------------------------------------------------------------------

PARALLEL_DDP_STEPS = 2
PARALLEL_TP = {"sd21": (3, 64), "tiny": (2, 8)}  # the TP UNet check's batch and latent side
# ControlNet losses of a DDP run against path 2's one-process run on the same
# draws, relative: the steps on the card are not bit-reproducible (cuDNN's
# backward), and two ranks run each of their 16 rows through other cuDNN and
# cuBLAS algorithms than one process at batch 32 (bf16 activations)
PARALLEL_LOSS_RTOL = {"world1": 1e-3, "two_ranks": 5e-3}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(rank: int, world: int):
    """torchrun's variables for a group on this host, restored after."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def controlnet_argv(work: str, size: str, steps: int, seed: int, out: str,
                    extra=()) -> list:
    """``train_controlnet.main``'s arguments on the synthetic dataset under
    ``work/data`` (``configs/controlnet_train.yaml``; ``tiny``: the tiny
    models at 16^2, batch 4)."""
    argv = ["--config", TRAIN_CONFIG, "--max-steps", str(steps), "sd_cache_dir=null",
            f"train_data_dir={work}/data", f"prompt_file_path={work}/data/prompts.json",
            f"controlnet_dir={work}/{out}", f"seed={seed}"]
    if size == "tiny":
        argv += ["model_size=tiny", "resolution=16", "train_batch_size=4"]
    return argv + list(extra)


def eval_colors(system, batch):
    """A DreamMat eval view's per-pixel shading (the field and the material
    on the G-buffer's foreground pixels) as ``fn`` and its arguments, for
    ``shard_rays``."""
    gb = batch["gbuffer"]

    def fn(pos, viewdir, normal, tri, bary):
        feats = system.geometry.apply(system.field, pos)
        out, _ = system.material(pos, feats, feats, viewdir, normal, batch["env_id"], None,
                                 is_train=False, vis_data=(tri, bary),
                                 light_table=batch.get("light_table"))
        return out["color"]

    return fn, (gb.fg_pos, gb.fg_viewdir, gb.fg_normal, gb.fg_tri, gb.fg_bary)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _param_vector(module) -> torch.Tensor:
    return torch.cat([p.detach().double().flatten().cpu() for p in module.parameters()])


def parallel_tp_check(rank: int, device: str, size: str, seed: int) -> dict:
    """The UNet split over two ranks (``tp_shard_params``, n_model = 2) on
    one batch, against the replicated UNet: both in bf16 on the card (fp32
    on the CPU), each against the replicated fp32 forward (attention plain:
    kernel A takes bf16 only). Kernel A's launches of the split forward by
    the heads each rank holds."""
    import copy

    from dreammat_tpu_torch.models.diffusion import convert
    from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
    from dreammat_tpu_torch.parallel.mesh import make_mesh, tp_shard_params

    cuda = device != "cpu"
    cfg = UNetConfig.sd21() if size == "sd21" else UNetConfig.tiny()
    dtype = torch.bfloat16 if cuda else torch.float32
    unet = convert.build_on(lambda: UNet2DCondition(cfg), device, dtype).eval()
    unet.requires_grad_(False)
    convert.random_init_(unet, torch.Generator(device=device).manual_seed(seed))
    B, lat = PARALLEL_TP[size]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(B, 4, lat, lat, generator=g, device=device)
    t = torch.randint(0, 1000, (B,), generator=g, device=device)
    ctx = torch.randn(B, 77, cfg.cross_attention_dim, generator=g, device=device)
    res = {}
    with torch.no_grad():
        if rank == 0:
            rep = unet(x.to(dtype), t, ctx.to(dtype)).float()
            ref = copy.deepcopy(unet).float()
            with plain_attention():
                exact = ref(x, t, ctx).float()
            del ref
        res["layers_split"] = tp_shard_params(make_mesh(1, 2), unet)
        with AttentionBatches(axis=2) as heads:
            split = unet(x.to(dtype), t, ctx.to(dtype)).float()
        if cuda:
            torch.cuda.synchronize()
    res["kernel_a_by_heads"] = heads.counts
    if rank == 0:
        res.update(split_vs_replicated=_rel_l2(split, rep), replicated_vs_fp32=_rel_l2(rep, exact),
                   split_vs_fp32=_rel_l2(split, exact), finite=bool(torch.isfinite(split).all()),
                   cos=float(torch.nn.functional.cosine_similarity(
                       split.flatten().double(), rep.flatten().double(), dim=0)))
    del unet
    if cuda:
        torch.cuda.empty_cache()
    return res


def parallel_rank(rank: int, world: int, work: str, device: str, size: str, seed: int,
                  ddp_steps: int) -> None:
    """One of the two ranks of path 12's second phase, on the one card over
    gloo (NCCL refuses two ranks on one device): the tensor-parallel UNet,
    DDP ControlNet training, ``shard_rays`` of a DreamMat eval view and
    ``rank_zero_fill``. Writes ``work/rank{rank}.pt``."""
    import torch.distributed as tdist

    import dreammat_tpu_torch
    import dreammat_tpu_torch.data  # noqa: F401 (registry)
    import dreammat_tpu_torch.models  # noqa: F401
    import dreammat_tpu_torch.systems  # noqa: F401
    from dreammat_tpu_torch import train_controlnet
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.parallel import distributed as dist
    from dreammat_tpu_torch.parallel.mesh import make_mesh, shard_rays
    from dreammat_tpu_torch.utils.config import load_config

    cuda = device != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{os.path.abspath(work)}/gloo_init",
                             rank=rank, world_size=world)
    out = {"rank": rank, "backend": tdist.get_backend(), "seconds": {}}
    try:
        t0 = time.time()
        out["tp"] = parallel_tp_check(rank, device, size, seed)
        out["seconds"]["tp"] = time.time() - t0

        counters = {"flash_attn_fwd": attn.flash_attention_fwd,
                    "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                    "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv}
        for fn in counters.values():
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = train_controlnet.main(controlnet_argv(work, size, ddp_steps, seed, "ddp"),
                                    device=device)
        tr = res["trainer"]
        out["ddp"] = {"losses": res["losses"], "step": res["step"], "mesh": tr.mesh.shape,
                      "counts": {k: fn.launches for k, fn in counters.items()},
                      "grad_allreduces": tr.grad_allreduces, "step_s": tr.step_seconds,
                      "checksum": float(_param_vector(tr.controlnet).sum()),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        out["seconds"]["ddp"] = time.time() - t0
        del res, tr
        if cuda:
            torch.cuda.empty_cache()

        t0 = time.time()
        if size == "tiny":
            cfg = load_config("configs/dreammat_tiny.yaml", [
                "system.prompt_processor.prompt=a ceramic vase",
                "system.geometry.shape_init=procedural:sphere",
                "system.geometry.shape_init_params=2", "system.material.use_prefiltered=true",
                "data.fix_view_num=1", "data.fastpath_check=false"])
        else:  # the guidance is not rendered: its tiny models keep the ranks light
            cfg = load_config("configs/dreammat.yaml", main_overrides(1) + [
                "system.guidance.model_size=tiny", "system.guidance.half_precision_weights=false",
                "system.prompt_processor.model_size=tiny"])
        system = dreammat_tpu_torch.find(cfg.system_type)(cfg.system, device=device)
        dm = dreammat_tpu_torch.find(cfg.data_type)(cfg.data, system.renderer, system.material,
                                                    device=device)
        dm.setup()
        system.init_state(seed)
        fn, fargs = eval_colors(system, dm.eval_view(0))
        with torch.no_grad():
            sharded, local = shard_rays(make_mesh(2, 1), fn, *fargs), fn(*fargs)
        out["render"] = {"pixels": fargs[0].shape[0],
                         "max_abs": float((sharded - local).abs().max()),
                         "checksum": float(sharded.double().sum())}
        out["seconds"]["render"] = time.time() - t0
        del system, dm, sharded, local

        calls, artifact = os.path.join(work, "fill_calls.txt"), os.path.join(work, "fill_artifact")

        def fill():
            with open(calls, "a") as f:
                f.write(f"{rank}\n")
            with open(artifact, "w") as f:
                f.write("x")

        out["fill"] = [dist.rank_zero_fill(artifact, fill, "smoke") for _ in range(2)]
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def parallel_batch_generate(work: str, device: str, size: str, obj: str,
                            timeout: int = 900) -> dict:
    """``batch_generate_torch.py`` twice at once, ``--shard 0/2`` and
    ``--shard 1/2``, over two DreamMat jobs on ``obj`` (2 steps, 4 views, 1
    test view, the export at 256^2). Each job must run once, in its own
    process, and write its ``save/`` files."""
    import glob
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    prompts = ["a glazed ceramic ring", "a brushed steel ring"]
    jobs = os.path.join(work, "jobs.json")
    with open(jobs, "w") as f:
        json.dump([{"mesh": obj, "prompt": p, "scale": 1.0, "max_steps": 2} for p in prompts], f)
    config = "configs/dreammat_tiny.yaml" if size == "tiny" else "configs/dreammat.yaml"
    extras = ["system.prompt_processor.use_cache=false", "system.guidance.cache_dir=null",
              "system.guidance.controlnet_path=null",
              "system.material.environment_texture=/nonexistent", "data.fix_view_num=4",
              "data.prerender_cache_dir=null", "data.n_test_views=1",
              "system.exporter.texture_size=256"]
    out_dir = os.path.join(work, "batch")
    procs, logs = [], []
    t0 = time.time()
    try:
        for i in range(2):
            logs.append(os.path.join(work, f"batch_shard{i}.log"))
            with open(logs[-1], "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(root, "batch_generate_torch.py"),
                     "--jobs", jobs, "--config", config, "--out", out_dir,
                     "--shard", f"{i}/2", "--device", device, *extras],
                    cwd=root, stdout=log_f, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=max(1, timeout - (time.time() - t0))) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.time() - t0
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    if rcs != [0, 0]:
        raise AssertionError(f"batch_generate_torch.py exit codes {rcs}; the end of the "
                             f"logs: {[t[-3000:] for t in texts]}")
    ran = [[line for line in t.splitlines() if "[job " in line] for t in texts]
    tests = sorted(glob.glob(os.path.join(out_dir, "**", "save", "it2-test", "0.png"),
                             recursive=True))
    exports = sorted(glob.glob(os.path.join(out_dir, "**", "save", "export", "model.obj"),
                               recursive=True))
    # shard i ran job i and nothing else; each job's trial wrote its files
    ok = all(len(r) == 1 and f"[job {i + 1}/2, shard {i}/2]" in r[0] and prompts[i] in r[0]
             for i, r in enumerate(ran)) and len(tests) == len(exports) == 2
    if not ok:
        raise AssertionError(f"batch generation: jobs run {ran}, test renders {tests}, "
                             f"exports {exports}")
    return {"seconds": seconds, "jobs_by_shard": ran, "test_pngs": tests,
            "png_bytes": [check_file(p, b"\x89PNG\r\n\x1a\n", 100) for p in tests]}


def drive_parallel(work: str, device: str = "cuda", size: str = "sd21", steps: int = 3,
                   ddp_steps: int = PARALLEL_DDP_STEPS, seed: int = 0,
                   ref_losses: Optional[list] = None, torus=(192, 96)) -> dict:
    """Main path 12: the port over more than one process.

    1. A torchrun group of one process (NCCL on the card, gloo on the CPU):
       ``train_controlnet.main`` for ``steps`` steps at the config's batch,
       the ControlNet in DDP, its gradient all-reduce counted by the
       trainer's comm hook; losses against ``ref_losses`` (path 2's run).
    2. Two ranks on the one card over gloo (``parallel_rank``): the UNet
       split over both, DDP ControlNet training for ``ddp_steps`` steps at
       the same global batch (half a rank), ``shard_rays`` of an eval view
       and ``rank_zero_fill``; the DDP run's losses and ControlNet against
       phase 1's at the same step.
    3. ``batch_generate_torch.py`` as two processes over two jobs."""
    import shutil

    import torch.distributed as tdist
    import torch.multiprocessing as tmp

    import dreammat_tpu_torch
    from dreammat_tpu_torch import train_controlnet
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj
    from dreammat_tpu_torch.ops import attention as attn
    from dreammat_tpu_torch.utils.ckpt import load_checkpoint

    cuda = device != "cpu"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    res = {"seconds": {}}
    write_controlnet_dataset(os.path.join(work, "data"), seed, res=16 if size == "tiny" else 256)
    counters = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv}

    # 1. world size 1 through torchrun's variables
    t0 = time.time()
    with torchrun_env(0, 1):
        for fn in counters.values():
            fn.launches = 0
        out = train_controlnet.main(controlnet_argv(work, size, steps, seed, "world1",
                                                    [f"checkpointing_steps={ddp_steps}"]),
                                    device=device)
        if cuda:
            torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        trainer = out["trainer"]
        backend = tdist.get_backend()
        allreduces = trainer.grad_allreduces
        explicit = None
        if allreduces == 0:  # DDP skipped its all-reduce: one explicit all-reduce and barrier
            dreammat_tpu_torch.warn("path 12: DDP ran no gradient all-reduce at world size 1")
            x = torch.ones(4, device=trainer.device)
            tdist.all_reduce(x)
            tdist.barrier()
            explicit = float(x.sum())
        tdist.destroy_process_group()
    w1 = {"backend": backend, "counts": counts, "grad_allreduces": allreduces,
          "explicit_all_reduce": explicit, "losses": out["losses"],
          "step_s": trainer.step_seconds}
    want_backend = "nccl" if cuda else "gloo"
    want = {k: n * steps for k, n in LAUNCHES_PER_TRAIN_STEP.items()}
    if backend != want_backend or (cuda and counts != want):
        raise AssertionError(f"path 12 world size 1: backend {backend}, launches {counts} "
                             f"(expected {want_backend}, {want})")
    if ref_losses is not None:
        w1["loss_rel_vs_path2"] = max(abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                                          ref_losses))
        if not (len(ref_losses) == steps and w1["loss_rel_vs_path2"]
                <= PARALLEL_LOSS_RTOL["world1"]):
            raise AssertionError(f"path 12 world size 1: losses {out['losses']} against path "
                                 f"2's {ref_losses}")
    del out, trainer
    res["world1"] = w1
    res["seconds"]["world1"] = time.time() - t0
    log(f"parallel: world size 1 over {backend}: {steps} ControlNet steps, DDP gradient "
        f"all-reduces {allreduces} (explicit {explicit}), launches {counts}, losses "
        f"{', '.join(f'{x:.6g}' for x in w1['losses'])}"
        + (f", max relative difference to path 2 {w1['loss_rel_vs_path2']:.3e}"
           if ref_losses is not None else "") + f", {res['seconds']['world1']:.1f}s")
    if cuda:
        torch.cuda.empty_cache()

    # 2. two ranks on the one card over gloo
    t0 = time.time()
    ctx = tmp.start_processes(parallel_rank, args=(2, work, device, size, seed, ddp_steps),
                              nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=900):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    res["seconds"]["two_ranks"] = time.time() - t0
    tp = ranks[0]["tp"]
    tp_heads = [r["tp"]["kernel_a_by_heads"] for r in ranks]
    # the split output no further from the replicated one than bf16 rounding
    # alone takes the replicated output from fp32 (three times that; fp32 on the CPU)
    tp_bound = max(3 * tp["replicated_vs_fp32"], 1e-5)
    d0, d1 = ranks[0]["ddp"], ranks[1]["ddp"]
    sd_w1, _, step_w1 = load_checkpoint(os.path.join(work, "world1", f"checkpoint-{ddp_steps}"))
    sd_two, _, step_two = load_checkpoint(os.path.join(work, "ddp", "controlnet_final"))
    ref = dreammat_tpu_torch.find("controlnet-trainer")(
        {"model_size": "tiny" if size == "tiny" else "sd21", "seed": seed}, device=device)
    ref.init_params()
    init = {k: v.double().cpu() for k, v in ref.controlnet.state_dict().items()}
    del ref
    mv_w1 = torch.cat([(sd_w1[k].double() - init[k]).flatten() for k in sorted(init)])
    mv_two = torch.cat([(sd_two[k].double() - init[k]).flatten() for k in sorted(init)])
    ddp = {"losses": d0["losses"], "loss_rel_vs_world1": max(
               abs(a - b) / abs(b) for a, b in zip(d0["losses"], w1["losses"][:ddp_steps])),
           "moved_cos": float(torch.nn.functional.cosine_similarity(mv_w1, mv_two, dim=0)),
           "moved_max": float(mv_w1.abs().max()), "max_abs_vs_world1": float(
               (mv_two - mv_w1).abs().max()), "counts": [d0["counts"], d1["counts"]],
           "grad_allreduces": [d0["grad_allreduces"], d1["grad_allreduces"]],
           "step_s": [d0["step_s"], d1["step_s"]], "peak_gb": [d0["peak_gb"], d1["peak_gb"]]}
    want_rank = {k: n * ddp_steps for k, n in LAUNCHES_PER_TRAIN_STEP.items()}
    with open(os.path.join(work, "fill_calls.txt")) as f:
        fill_calls = f.read().split()
    res["two_ranks"] = {"backend": [r["backend"] for r in ranks], "tp": tp,
                        "tp_kernel_a_by_heads": tp_heads, "tp_bound": tp_bound, "ddp": ddp,
                        "render": [r["render"] for r in ranks], "fill_calls": fill_calls,
                        "seconds_by_rank": [r["seconds"] for r in ranks]}
    checks = {
        "tp split within the bf16 bound": tp["split_vs_replicated"] <= tp_bound and tp["finite"],
        "tp layers split on both ranks": ranks[0]["tp"]["layers_split"]
        == ranks[1]["tp"]["layers_split"] > 0,
        "ddp losses equal on both ranks": d0["losses"] == d1["losses"],
        "ddp ControlNet equal on both ranks": d0["checksum"] == d1["checksum"],
        "ddp losses against world size 1": ddp["loss_rel_vs_world1"]
        <= PARALLEL_LOSS_RTOL["two_ranks"],
        "ddp ControlNet moved as at world size 1": ddp["moved_cos"] >= 0.99
        and step_w1 == step_two == ddp_steps,
        "ddp all-reduced": min(ddp["grad_allreduces"]) > 0 and d0["mesh"] == {"data": 2,
                                                                             "model": 1},
        "render sharded as local": all(r["render"]["max_abs"] <= 1e-6 for r in ranks)
        and ranks[0]["render"]["checksum"] == ranks[1]["render"]["checksum"],
        "rank_zero_fill once": fill_calls == ["0"] and all(r["fill"] == [True, True]
                                                            for r in ranks),
    }
    if cuda:
        # the SD2.1 UNet's 32 attentions at n_model = 2: the 320-wide blocks'
        # 10 keep their 5 heads whole; the 640-wide blocks' 10 (10 heads) and
        # the 1280-wide blocks' 12 (20 heads) hold 5 and 10 a rank
        checks["tp kernel A at the local heads"] = all(h == {5: 20, 10: 12} for h in tp_heads)
        checks["ddp launches a rank"] = all(c == want_rank for c in ddp["counts"])
    bad = [k for k, ok in checks.items() if not ok]
    log(f"parallel: two ranks on one device over {ranks[0]['backend']} in "
        f"{res['seconds']['two_ranks']:.1f}s (by rank and part {res['two_ranks']['seconds_by_rank']}): "
        f"tensor-parallel UNet ({tp['layers_split']} layers split, kernel A by local heads "
        f"{tp_heads}) against replicated {tp['split_vs_replicated']:.3e} (bound {tp_bound:.3e}; "
        f"replicated against fp32 {tp['replicated_vs_fp32']:.3e}, split against fp32 "
        f"{tp['split_vs_fp32']:.3e}, cos {tp['cos']:.6f}); DDP {ddp_steps} steps at "
        f"{d0['mesh']}: losses {', '.join(f'{x:.6g}' for x in d0['losses'])}, max relative "
        f"difference to world size 1 {ddp['loss_rel_vs_world1']:.3e}, ControlNet movement cos "
        f"{ddp['moved_cos']:.6f} (max |moved| {ddp['moved_max']:.3e}, max |diff| "
        f"{ddp['max_abs_vs_world1']:.3e}), all-reduces {ddp['grad_allreduces']}, launches a "
        f"rank {ddp['counts']}, steps {ddp['step_s']}, peak {ddp['peak_gb']} GB; eval view "
        f"through shard_rays ({ranks[0]['render']['pixels']} pixels) max|diff| "
        f"{[r['render']['max_abs'] for r in ranks]}; rank_zero_fill calls {fill_calls}")
    if bad:
        raise AssertionError(f"path 12 two ranks: {bad}")

    # 3. batch generation, two processes
    t0 = time.time()
    v, f = torus_arrays(0.7, 0.28, *torus)
    obj = write_obj(os.path.join(work, "torus.obj"), v, f)
    res["batch"] = parallel_batch_generate(work, device, size, obj)
    res["seconds"]["batch"] = time.time() - t0
    log(f"parallel: batch_generate_torch.py --shard 0/2 and 1/2 at once in "
        f"{res['batch']['seconds']:.1f}s: jobs {res['batch']['jobs_by_shard']}, test PNGs "
        f"{res['batch']['png_bytes']} bytes")
    res["counts"] = {k: w1["counts"][k] for k in counters}
    return res


def phase_parallel(ref_losses: list, seed: int) -> dict:
    """Main path 12 on the card (``drive_parallel`` at full width)."""
    import shutil

    work = os.path.join("outputs", "chip_smoke_parallel")
    res = drive_parallel(work, seed=seed, ref_losses=ref_losses)
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
    phase_s = {}

    def timed(name, fn, *a, **k):
        """fn(*a, **k), its seconds added to ``phase_s[name]``."""
        t0 = time.time()
        try:
            return fn(*a, **k)
        finally:
            phase_s[name] = phase_s.get(name, 0.0) + time.time() - t0

    timed("build", phase_build, args.out)
    sass = timed("sass", check_sass)
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_res = timed("attention", phase_attention, gen)
    # the texcraft path's batches: SDS (2 replicas) and Perp-Neg SDS (4)
    attn_sds = {B: timed("attention_sds", phase_attention, gen, B) for B in (2, 4)}
    import yaml

    with open(TRAIN_CONFIG) as f:
        batch = yaml.safe_load(f)["train_batch_size"]
    bwd_res = timed("attention_bwd", phase_attention_bwd, gen, batch)
    # the volume path's shapes: kernel A at B = 2 (SDS and both VSD CFG
    # passes) and B = 1 (the LoRA regression), C and D at B = 1
    attn_vol = {f"{lat}_b{B}": timed("attention_volume", phase_attention, gen, B, shapes)
                for lat, shapes in VOLUME_ATTN_SHAPES.items() for B in (2, 1)}
    bwd_vol = {f"{lat}_b1": timed("attention_volume", phase_attention_bwd, gen, 1,
                                  [(1, N, M, H) for N, M, H in shapes], autograd_check=False)
               for lat, shapes in VOLUME_ATTN_SHAPES.items()}
    # the DMTet path's VSD runs render at 512^2 (64^2 latents): kernel A at
    # B = 1 (the LoRA regression; B = 2 is attn_sds's), C and D at B = 1
    attn_vol["latent64_b1"] = timed("attention_dmtet", phase_attention, gen, 1, ATTN_SHAPES)
    bwd_vol["latent64_b1"] = timed("attention_dmtet", phase_attention_bwd, gen, 1,
                                   [(1, N, M, H) for N, M, H in ATTN_SHAPES],
                                   autograd_check=False)
    # the Zero123 UNet at 32^2 latents, cross-attention to one image token:
    # kernel A at B = 2 (the CFG passes) and 1 (the VSD regression), C and D at B = 1
    for B in (2, 1):
        attn_vol[f"zero123_b{B}"] = timed("attention_zero123", phase_attention, gen, B,
                                          ZERO123_ATTN_SHAPES)
    bwd_vol["zero123_b1"] = timed("attention_zero123", phase_attention_bwd, gen, 1,
                                  [(1, N, M, H) for N, M, H in ZERO123_ATTN_SHAPES],
                                  autograd_check=False)
    vol_rows = volume_kernel_rows(attn_vol, bwd_vol)
    cast_res = timed("ray_cast", phase_ray_cast)
    counts = {"flash_attn_fwd": None, "ray_cast": None}
    cn_counts = {"flash_attn_fwd": None, "flash_attn_bwd_dq": None, "flash_attn_bwd_dkv": None}
    l_counts = {"flash_attn_fwd": None, "ray_cast": None}
    u_counts = {"flash_attn_fwd": None, "ray_cast": None}
    o_counts = {"flash_attn_fwd": None, "ray_cast": None}
    t_counts = {"flash_attn_fwd": None, "ray_cast": None}
    v_counts = {"flash_attn_fwd": None, "flash_attn_bwd_dq": None, "flash_attn_bwd_dkv": None}
    d_counts = {"flash_attn_fwd": None, "flash_attn_bwd_dq": None, "flash_attn_bwd_dkv": None,
                "ray_cast": None}
    r_counts = dict(d_counts)
    main_res = cn_res = launch_res = user_res = opt_res = tex_res = vol_res = dmtet_res = None
    rest_res = single_res = edit_res = par_res = None
    s_counts = dict(d_counts)
    e_counts = dict(d_counts)
    if not args.kernels_only:
        main_res = timed("main", phase_main, args.steps, args.views, args.out)
        counts = main_res["counts"]
        cn_res = timed("controlnet", phase_controlnet, args.steps, batch, args.seed,
                       os.path.join("outputs", "chip_smoke_controlnet"))
        cn_counts = cn_res["counts"]
        launch_res = timed("launch", phase_launch, args.out, cast_res["clock"])
        l_counts = launch_res["counts"]
        user_res = timed("user_files", phase_user_files, cast_res["clock"])
        u_counts = user_res["counts"]
        opt_res = timed("options", phase_options, cast_res["clock"], main_res["warm_step_s"])
        o_counts = opt_res["counts"]
        tex_res = timed("texcraft", phase_texcraft)
        t_counts = tex_res["counts"]
        vol_res = timed("volume", phase_volume)
        v_counts = vol_res["counts"]
        dmtet_res = timed("dmtet", phase_dmtet, cast_res["clock"])
        d_counts = dmtet_res["counts"]
        rest_res = timed("volume_rest", phase_volume_rest)
        r_counts = rest_res["counts"]
        single_res = timed("single_image", phase_single_image)
        s_counts = single_res["counts"]
        edit_res = timed("edit", phase_edit)
        e_counts = edit_res["counts"]
        par_res = timed("parallel", phase_parallel, cn_res["losses"], args.seed)

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
                                  "playground": tex_res["playground"]["flash_attn_fwd_by_batch"]},
                              "volume": v_counts["flash_attn_fwd"],
                              "volume_by_run_and_batch": vol_res and {
                                  run: r["flash_attn_fwd_by_batch"]
                                  for run, r in vol_res["runs"].items()},
                              "dmtet": d_counts["flash_attn_fwd"],
                              "dmtet_by_run_and_batch": dmtet_res and {
                                  run: r["flash_attn_fwd_by_batch"]
                                  for run, r in dmtet_res["runs"].items()},
                              "volume_rest": r_counts["flash_attn_fwd"],
                              "volume_rest_by_run_and_batch": rest_res and {
                                  run: r["flash_attn_fwd_by_batch"]
                                  for run, r in rest_res["runs"].items()},
                              "single_image": s_counts["flash_attn_fwd"],
                              "single_image_by_run_and_batch": single_res and {
                                  **{run: r["flash_attn_fwd_by_batch"]
                                     for run, r in single_res["runs"].items()},
                                  "zero123_vsd":
                                      single_res["zero123_vsd"]["flash_attn_fwd_by_batch"]},
                              "parallel_nccl_world1": par_res and par_res["counts"][
                                  "flash_attn_fwd"],
                              "parallel_gloo_ddp_by_rank": par_res and [
                                  c["flash_attn_fwd"] for c in par_res["two_ranks"]["ddp"]["counts"]],
                              "parallel_gloo_tp_by_rank_and_heads": par_res and par_res[
                                  "two_ranks"]["tp_kernel_a_by_heads"],
                              "edit": e_counts["flash_attn_fwd"],
                              "edit_by_run_and_batch": edit_res and {
                                  **{run: r["flash_attn_fwd_by_batch"]
                                     for run, r in edit_res["runs"].items()},
                                  "ip2p_sds": edit_res["ip2p_sds"]["flash_attn_fwd_by_batch"]}},
         "volume_and_dmtet_shapes": vol_rows["flash_attn_fwd"],
         "perp_neg_b5": user_res and {k: user_res["attention_b5"][k] for k in (
             "B", "N", "M", "H", "max_err", "ms", "graph_ms", "plain_ms", "lib_ms",
             "lib_graph_ms", "bound_ms", "by")},
         "sds_batches": {f"b{B}": {"max_abs_err": max(r["max_err"] for r in res["rows"]),
                                   **{k: max(res["rows"], key=lambda r: r["N"] * r["M"])[k]
                                      for k in ("N", "M", "H", "ms", "graph_ms", "host_us",
                                                "plain_ms", "lib_ms", "lib_graph_ms",
                                                "bound_ms", "by")}}
                         for B, res in attn_sds.items()},
         "max_abs_err": max(r["max_err"] for res in (attn_res, *attn_sds.values(),
                                                     *attn_vol.values())
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
         "launches_by_path": {"controlnet_training": cn_counts["flash_attn_bwd_dq"],
                              "volume": v_counts["flash_attn_bwd_dq"],
                              "dmtet": d_counts["flash_attn_bwd_dq"],
                              "volume_rest": r_counts["flash_attn_bwd_dq"],
                              "single_image": s_counts["flash_attn_bwd_dq"],
                              "edit": e_counts["flash_attn_bwd_dq"],
                              "parallel_nccl_world1": par_res and par_res["counts"]["flash_attn_bwd_dq"],
                              "parallel_gloo_ddp_by_rank": par_res and [
                                  c["flash_attn_bwd_dq"] for c in par_res["two_ranks"]["ddp"]["counts"]]},
         "volume_and_dmtet_shapes": vol_rows["flash_attn_bwd_dq"],
         "max_abs_err": max(r["errs"]["dq"]["max"] for res in (bwd_res, *bwd_vol.values())
                            for r in res["rows"]),
         "ms": c["dq_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["dq_bound_ms"],
         "bound_by": c["dq_by"], "library_ms": c["lib_dq_ms"], "graph_ms": c["dq_graph_ms"],
         "host_us": c["dq_host_us"], "library_graph_ms": c["lib_dq_graph_ms"],
         "library_host_us": c["lib_dq_host_us"], "sass": sass["flash_attn_bwd_dq"],
         "work": c_work + "; plain_ms computes dq, dk and dv; library: autograd of SDPA wrt q"},
        {"name": "flash_attn_bwd_dkv", "route": "cuda",
         "source": "dreammat_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "dreammat_tpu/ops/attention.py:146",
         "launches": cn_counts["flash_attn_bwd_dkv"],
         "launches_by_path": {"controlnet_training": cn_counts["flash_attn_bwd_dkv"],
                              "volume": v_counts["flash_attn_bwd_dkv"],
                              "dmtet": d_counts["flash_attn_bwd_dkv"],
                              "volume_rest": r_counts["flash_attn_bwd_dkv"],
                              "single_image": s_counts["flash_attn_bwd_dkv"],
                              "edit": e_counts["flash_attn_bwd_dkv"],
                              "parallel_nccl_world1": par_res and par_res["counts"]["flash_attn_bwd_dkv"],
                              "parallel_gloo_ddp_by_rank": par_res and [
                                  c["flash_attn_bwd_dkv"] for c in par_res["two_ranks"]["ddp"]["counts"]]},
         "volume_and_dmtet_shapes": vol_rows["flash_attn_bwd_dkv"],
         "max_abs_err": max(max(r["errs"]["dk"]["max"], r["errs"]["dv"]["max"])
                            for res in (bwd_res, *bwd_vol.values()) for r in res["rows"]),
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
                                  for run, r in tex_res["runs"].items()},
                              "dmtet": d_counts["ray_cast"],
                              "dmtet_by_run_and_stage": dmtet_res and {
                                  run: r["ray_cast"] for run, r in dmtet_res["runs"].items()},
                              "volume_rest": r_counts["ray_cast"],
                              "single_image": s_counts["ray_cast"],
                              "single_image_by_run": single_res and {
                                  run: r["launches"]["ray_cast"]
                                  for run, r in single_res["runs"].items()},
                              "edit_capture": e_counts["ray_cast"]},
         "traffic": [{k: r[k] for k in ("label", "R", "T", "checked", "pairs", "ms", "bound_ms",
                                        "by", "bound_all_pairs_ms", "flips", "face_diff",
                                        "pairs_morton", "bound_tested_ms", "bound_morton_ms")
                                if k in r}
                     for r in ((launch_res["ray_cast"] if launch_res else [])
                               + ([user_res["ray_cast_view"]] if user_res else [])
                               + ([opt_res["ray_cast_sampled_view"]] if opt_res else [])
                               + ([{**r["cast_vs_plain"], "label": f"{run}: "
                                    + r["cast_vs_plain"]["label"]}
                                   for run, r in dmtet_res["runs"].items()]
                                  if dmtet_res else []))],
         "max_abs_err": max(r["t_err"] for r in cast_res["rows"]),
         "sm_clock_mhz": b["sm_clock_mhz"],
         "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
         "bound_by": b["by"], "library_ms": None,
         "work": f"R={b['R']} rays x T={b['T']} triangles fp32, {b['pairs']:.4g} pairs "
                 f"tested after the cull; bound over all pairs {b['bound_all_pairs_ms']:.4g} ms"},
    ]
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump({"attention": attn_res, "attention_sds": attn_sds, "texcraft": tex_res,
                   "attention_volume": attn_vol, "attention_bwd_volume": bwd_vol,
                   "volume": vol_res, "dmtet": dmtet_res, "volume_rest": rest_res,
                   "single_image": single_res, "edit": edit_res, "parallel": par_res,
                   "attention_bwd": bwd_res, "ray_cast": cast_res, "sass": sass,
                   "kernels": kernels, "main": main_res, "controlnet": cn_res,
                   "launch": launch_res, "user_files": user_res, "options": opt_res,
                   "phase_seconds": phase_s, "card": card}, f, indent=1,
                  default=str)
    log(f"phase seconds {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(f"total {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
