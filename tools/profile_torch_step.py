"""Where the time of one train step of the PyTorch/CUDA port goes.

    python3 tools/profile_torch_step.py [--views 2] [--warmup 2] [--steps 3]

Sets up the main path of ``chip_smoke.py`` (its ``main_config``:
``configs/dreammat.yaml``, tables regime, SD2.1 width, random bf16
weights, level-6 icosphere), runs
``--warmup`` train steps, then traces ``--steps`` more with
``torch.profiler`` (CPU and CUDA activities). Prints the device time by
kernel class and the top kernels, the device's busy share of the traced
window, and the host-clock step times; with ``--trace`` also writes the
Chrome trace (tens of MB) to ``<out>/trace.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# first matching substring of a kernel's name decides its class
CLASSES = [
    ("kernel A (flash_attn_fwd)", ("flash_fwd_kernel",)),
    ("kernel B (ray_cast)", ("ray_cast_kernel",)),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="outputs/profile_torch_step")
    ap.add_argument("--trace", action="store_true", help="write the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dreammat_tpu_torch
    from chip_smoke import main_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cfg = main_config(args.views)
    find = dreammat_tpu_torch.find
    system = find(cfg.system_type)(cfg.system)
    dm = find(cfg.data_type)(cfg.data, system.renderer, system.material)
    dm.setup()
    trial = os.path.join(args.out, "trial")
    system.fit(dm, max_steps=args.warmup, seed=0, trial_dir=trial, log_every=args.warmup)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        system.fit(dm, max_steps=args.warmup + args.steps, seed=0, trial_dir=trial,
                   log_every=args.steps)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))

    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
            by_class[classify(e.name)] += us
            by_name[e.name][0] += us
            by_name[e.name][1] += 1
    dev_ms = sum(by_class.values()) / 1e3
    steps = args.steps
    print(f"traced {steps} steps: wall {wall_ms:.1f} ms ({wall_ms / steps:.1f} ms/step), "
          f"device busy {dev_ms:.1f} ms ({dev_ms / steps:.1f} ms/step, "
          f"{100.0 * dev_ms / wall_ms:.1f}% of the window, idle {100.0 - 100.0 * dev_ms / wall_ms:.1f}%)")
    print("step seconds (host clock after synchronize): "
          + ", ".join(f"{s:.4f}" for s in system.step_seconds))
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:28s} {us / 1e3 / steps:9.3f} ms/step  {100.0 * us / 1e3 / dev_ms:5.1f}%")
    print("top kernels (ms/step, launches/step):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3 / steps:8.3f} {n / steps:6.1f}  {name[:110]}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
