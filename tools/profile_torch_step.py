"""Where the time of one train step of the PyTorch/CUDA port goes.

    python3 tools/profile_torch_step.py [--views 2] [--warmup 2] [--steps 3]
    python3 tools/profile_torch_step.py --mc-torus [--views 2] [--warmup 2] [--steps 3]
    python3 tools/profile_torch_step.py --controlnet [--warmup 2] [--steps 3]
    python3 tools/profile_torch_step.py --gate
    python3 tools/profile_torch_step.py --volume dreamfusion|prolificdreamer

Sets up one of the paths of ``chip_smoke.py``: DreamMat material
generation (its ``main_config``: ``configs/dreammat.yaml``, tables regime,
SD2.1 width, random bf16 weights, level-6 icosphere); with ``--mc-torus``
the same config on main path 3's torus (36,864 triangles) with
``hybrid_mc_every=1``, so that every step shades through the Monte-Carlo
estimator; or with ``--controlnet`` ControlNet training (``ControlNetTrainer`` at the defaults
of ``configs/controlnet_train.yaml``: SD2.1 width, resolution 256, random
weights, one batch of ``train_batch_size`` (32) random images and
conditions made with numpy from seed 0); or with ``--volume`` one run of
main path 7 (``configs/dreamfusion.yaml`` at 64^2, or
``configs/prolificdreamer.yaml`` at 128^2, with ``chip_smoke.py``'s
overrides). Runs ``--warmup`` train steps, then traces ``--steps``
more with ``torch.profiler`` (CPU and CUDA activities), then times ``--steps``
more without it. Prints the device time by kernel class and the top kernels,
the device's busy share of the traced window and of the unprofiled step
(the profiler's own overhead is the ratio of the two step times), and the
host-clock step times; with ``--trace`` also writes the Chrome trace (tens
of MB) to ``<out>/trace.json``.

``--gate`` runs main path 3's ``launch_torch.py --train`` (the torus, 4
views, 3 steps, ``hybrid_mc_every=2``, 2 test views, the export) alone in
this fresh process, as a user runs it, with the fast-path gate's gradient
cosine traced by ``torch.profiler`` (its first call: the cost a user's run
pays once, less the import of ``torch._dynamo`` that the first
``torch.utils.checkpoint`` call makes, which is timed apart just before),
then times the cosine twice more untraced. Prints the run's,
the gate's and the steps' seconds and, for the traced call, its device
busy time and the host operations that took the most time. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# first matching substring of a kernel's name decides its class
CLASSES = [
    ("kernel A (flash_attn_fwd)", ("flash_fwd_sm90_kernel",)),
    ("kernel C (flash_attn_bwd_dq)", ("flash_bwd_dq_sm90_kernel",)),
    ("kernel D (flash_attn_bwd_dkv)", ("flash_bwd_dkv_sm90_kernel",)),
    ("kernel B (ray_cast)", ("ray_cast_kernel",)),
    ("host<->device copy", ("memcpy htod", "memcpy dtoh")),
    ("cuDNN layout transform", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "winograd")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("normalization", ("norm", "welford", "moments", "internalgradients")),
    ("softmax", ("softmax",)),
    ("gather/scatter/index", ("index", "scatter", "gather")),
    ("reduction", ("reduce",)),
]


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise/other"


def setup_dreammat(args):
    """(run(n): n more train steps, host-clock step seconds)."""
    import dreammat_tpu_torch
    from chip_smoke import main_config, main_overrides
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj
    from dreammat_tpu_torch.utils.config import load_config

    if args.mc_torus:
        obj = write_obj(os.path.join(args.out, "torus.obj"), *torus_arrays(0.7, 0.28, 192, 96))
        cfg = load_config("configs/dreammat.yaml", main_overrides(args.views, f"mesh:{obj}", "1.0")
                          + ["data.hybrid_mc_every=1"])
    else:
        cfg = main_config(args.views)
    find = dreammat_tpu_torch.find
    system = find(cfg.system_type)(cfg.system)
    dm = find(cfg.data_type)(cfg.data, system.renderer, system.material)
    dm.setup()
    trial = os.path.join(args.out, "trial")

    def run(n):
        system.fit(dm, max_steps=system.global_step + n, seed=0, trial_dir=trial, log_every=n)

    return run, system.step_seconds


def profile_gate(args):
    """Main path 3's ``launch_torch.py --train`` run alone in this fresh
    process, as a user runs it, with the gate's gradient cosine traced
    (its first call, inside the datamodule's setup); then the cosine twice
    more, untraced."""
    import launch_torch
    from chip_smoke import main_overrides
    from dreammat_tpu_torch.data import prerender as prerender_lib
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj

    obj = write_obj(os.path.join(args.out, "torus.obj"), *torus_arrays(0.7, 0.28, 192, 96))
    real = prerender_lib.fastpath_grad_cos
    profs, secs = [], {}

    def traced(*a, **k):
        if not profs:
            # torch.utils.checkpoint's first call imports torch._dynamo
            # (its ``torch._disable_dynamo`` wrapper): time that apart
            secs["had_dynamo"] = "torch._dynamo" in sys.modules
            t0 = time.time()
            importlib.import_module("torch._dynamo")
            secs["import"] = time.time() - t0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        t0 = time.time()
        with torch.profiler.profile(activities=acts) as prof:
            out = real(*a, **k)
            torch.cuda.synchronize()
        secs.setdefault("traced", time.time() - t0)
        profs.append(prof)
        return out

    prerender_lib.fastpath_grad_cos = traced
    argv = ["--config", "configs/dreammat.yaml", "--train", "--device", "cuda",
            *main_overrides(4, f"mesh:{obj}", "1.0"), "data.fix_env_num=5",
            "trainer.max_steps=3", "data.hybrid_mc_every=2", "data.n_test_views=2",
            f"exp_root_dir={os.path.join(args.out, 'launch')}", "use_timestamp=false"]
    t0 = time.time()
    try:
        res = launch_torch.main(argv)
    finally:
        prerender_lib.fastpath_grad_cos = real
    torch.cuda.synchronize()
    run_s = time.time() - t0
    system, dm = res["system"], res["datamodule"]
    gate = dm.gate
    print(f"launch_torch.py --train alone: {run_s:.2f} s; gate {gate['seconds']:.3f} s (RMSE "
          f"{gate['rmse']:.4f} in {gate['rmse_s']:.3f} s, grad-cos {gate['grad_cos']:.4f} in "
          f"{gate['grad_cos_s']:.3f} s), {gate['decision']}; steps "
          + ", ".join(f"{k} {x:.4f} s" for k, x in zip(system.step_kinds, system.step_seconds))
          + "; export " + ", ".join(f"{k} {v:.3f} s" for k, v in system.exporter.seconds.items()))
    warm = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.time()
        real(system.renderer, system.material, dm.data, grad_pixels=dm.cfg.fastpath_grad_pixels)
        torch.cuda.synchronize()
        warm.append(time.time() - t1)
    prof = profs[0]
    dev_ms = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
                 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)) / 1e3
    print(f"gate grad-cos: {gate['grad_cos_s']:.3f} s in the gate = import of torch._dynamo "
          f"{secs['import']:.3f} s (imported before: {secs['had_dynamo']}) + first call "
          f"{secs['traced']:.3f} s traced (device busy {dev_ms:.1f} ms); then "
          f"{', '.join(f'{x:.3f}' for x in warm)} s untraced")
    print("first grad-cos call, host operations by self CPU time (ms, calls):")
    rows = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)[:20]
    for k in rows:
        print(f"  {k.self_cpu_time_total / 1e3:10.1f} {k.count:7d}  {k.key[:100]}")


def setup_volume(args):
    """Main path 7's system and datamodule for ``args.volume``."""
    import dreammat_tpu_torch
    from chip_smoke import volume_overrides
    from dreammat_tpu_torch.utils.config import load_config

    trial = os.path.join(args.out, "volume")
    cfg = load_config(f"configs/{args.volume}.yaml",
                      volume_overrides(trial, "sd21", args.volume, 0))
    find = dreammat_tpu_torch.find
    system = find(cfg.system_type)(cfg.system)
    dm = find(cfg.data_type)(cfg.data, system.renderer, system.material)
    dm.setup()

    def run(n):
        system.fit(dm, max_steps=system.global_step + n, seed=0, trial_dir=trial, log_every=n,
                   val_check_interval=0, checkpoint_every=0)

    return run, system.step_seconds


def setup_controlnet(args):
    import dreammat_tpu_torch

    trainer = dreammat_tpu_torch.find("controlnet-trainer")({}, device="cuda")
    trainer.init_params()
    trainer.make_optimizer()
    res, n = trainer.cfg.resolution, trainer.cfg.train_batch_size
    rng = np.random.default_rng(0)
    batch = {"target": rng.random((n, res, res, 3), dtype=np.float32),
             "condition": rng.random((n, res, res, 22), dtype=np.float32),
             "prompts": ["a ceramic vase with a glossy glaze"] * n}

    def run(n):
        for _ in range(n):
            t0 = time.time()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            trainer.step_seconds.append(time.time() - t0)

    return run, trainer.step_seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="outputs/profile_torch_step")
    ap.add_argument("--trace", action="store_true", help="write the Chrome trace")
    ap.add_argument("--mc-torus", action="store_true",
                    help="DreamMat on the torus, every step through the MC estimator")
    ap.add_argument("--controlnet", action="store_true",
                    help="profile a ControlNet training step instead of a DreamMat one")
    ap.add_argument("--gate", action="store_true",
                    help="run main path 3 alone, the gate's first grad-cos traced")
    ap.add_argument("--volume", choices=("dreamfusion", "prolificdreamer"),
                    help="profile a step of main path 7's run of this config")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.gate:
        profile_gate(args)
        print(card)
        return 0
    run, step_seconds = (setup_controlnet if args.controlnet else
                         setup_volume if args.volume else setup_dreammat)(args)
    run(args.warmup)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        run(args.steps)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))

    launches = sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                           "cudaLaunchKernelExC"))
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        # user annotations (Optimizer.step#...) mirror their kernels' span
        # on the device and would count those kernels twice
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            us = e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
            by_class[classify(e.name)] += us
            by_name[e.name][0] += us
            by_name[e.name][1] += 1
    dev_ms = sum(by_class.values()) / 1e3
    steps = args.steps
    print(f"traced {steps} steps: wall {wall_ms:.1f} ms ({wall_ms / steps:.1f} ms/step), "
          f"device busy {dev_ms:.1f} ms ({dev_ms / steps:.1f} ms/step, "
          f"{100.0 * dev_ms / wall_ms:.1f}% of the window, idle {100.0 - 100.0 * dev_ms / wall_ms:.1f}%)")
    traced_step = list(step_seconds[-steps:])
    run(steps)
    plain = step_seconds[-steps:]
    plain_ms = 1e3 * sum(plain) / len(plain)
    print(f"unprofiled: {plain_ms:.1f} ms/step over {steps} steps, device busy "
          f"{100.0 * dev_ms / steps / plain_ms:.1f}% of it, idle "
          f"{100.0 - 100.0 * dev_ms / steps / plain_ms:.1f}%; traced steps "
          f"{1e3 * sum(traced_step) / steps:.1f} ms/step (profiler overhead "
          f"{sum(traced_step) / steps / (plain_ms / 1e3):.2f}x)")
    print(f"kernel launches from the host: {launches / steps:.0f} per step")
    print("step seconds (host clock after synchronize): "
          + ", ".join(f"{s:.4f}" for s in step_seconds))
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:28s} {us / 1e3 / steps:9.3f} ms/step  {100.0 * us / 1e3 / dev_ms:5.1f}%")
    print("top kernels (ms/step, launches/step):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3 / steps:8.3f} {n / steps:6.1f}  {name[:110]}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
