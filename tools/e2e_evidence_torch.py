"""End-to-end evidence row of the PyTorch/CUDA port.

    python3 tools/e2e_evidence_torch.py --mesh <mesh>.obj [--steps 30] [--views 8] \\
        [--out reports/e2e_torch.json]
    python3 tools/e2e_evidence_torch.py --device cpu --config configs/dreammat_tiny.yaml \\
        --mesh <mesh>.obj --res 32 --steps 2 --views 2      # tiny, on the CPU

The twin of ``tools/e2e_evidence.py``: it runs the user's path,
``launch_torch.py --train`` (the datamodule's prerender and gate, the
training steps, the test renders and the OBJ export) in a subprocess with
random weights and the JAX tool's overrides, and writes one JSON row to
``--out``: the wall clock of the run, its phases, a fixed-seed render
fingerprint (mean RGB and the first 16 hex digits of the sha256 of the
first test view's pixels) and the exported files. The phases come from
the port's log lines (``prerender: G-buffers ... in Xs``, ``mesh-wide
bakes``, ``probes+tables``, ``test render: Xs``, ``export: Xs``) and from
the trial's ``logs/metrics.csv`` (``trainer.log_every_n_steps=1``: each
step's seconds, so the first step's and the warm rate of the rest). The
port keeps no static field maps, so ``static_maps_s`` is null, with the
reason in the row. A run that times out (``--timeout``) or exits nonzero
still writes its row, with ``"failed"`` (``"timeout"`` or the return code),
the phases its log reached and the log's tail; the tool then exits 1.
Trailing ``key=value`` arguments are passed on after the tool's own
overrides. The subprocess runs on the card unless ``--device cpu`` is
given, and the tool raises without a card before starting it.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
APPLE = "load/shapes/objs/apple.obj"
STATIC_MAPS_NOTE = ("the port keeps no static field maps (its datamodule builds none), so "
                    "no such phase exists")


def launch_argv(args, trial_root: str) -> list:
    """The subprocess's command: ``launch_torch.py --train`` on the mesh with
    the JAX tool's overrides, hermetic (its own prerender cache)."""
    H = args.res
    trial = os.path.join(trial_root, "dream_mat", args.tag)
    return [
        sys.executable, "launch_torch.py", "--config", args.config, "--train",
        "--device", args.device, "trainer.log_every_n_steps=1",
        "system.prompt_processor.prompt=a red apple",
        f"system.geometry.shape_init=mesh:{args.mesh}",
        "system.geometry.shape_init_params=0.7",
        "system.geometry.shape_init_mesh_up=+y",
        "system.geometry.shape_init_mesh_front=+z",
        f"trainer.max_steps={args.steps}",
        f"data.fix_view_num={args.views}", "data.fix_env_num=2",
        f"data.width={H}", f"data.height={H}",
        f"data.eval_width={H}", f"data.eval_height={H}",
        "data.n_test_views=2", "seed=0",
        "name=dream_mat", f"tag={args.tag}", "use_timestamp=false",
        f"exp_root_dir={trial_root}",
        "trainer.val_check_interval=0",
        # no cross-run prerender reuse
        f"data.prerender_cache_dir={trial}/.pre_cache",
        *args.overrides,
    ]


def parse_phases(log: str, trial: str) -> dict:
    """The phase seconds of one run from its log and its ``metrics.csv``."""
    def grab(pattern):
        m = re.findall(pattern, log)
        return float(m[-1]) if m else None

    seconds = []
    path = os.path.join(trial, "logs", "metrics.csv")
    if os.path.exists(path):
        with open(path) as f:
            seconds = [float(r["seconds"]) for r in csv.DictReader(f)]
    warm = seconds[1:]
    return {
        "prerender_gbuffers_s": grab(r"G-buffers for \d+ views in ([\d.]+)s"),
        "prerender_bakes_s": grab(r"mesh-wide bakes in ([\d.]+)s"),
        "prerender_probes_tables_s": grab(r"probes\+tables for \d+ views in ([\d.]+)s"),
        "static_maps_s": None,
        "first_step_s": seconds[0] if seconds else None,
        "warm_steps_per_sec": len(warm) / sum(warm) if warm and sum(warm) > 0 else None,
        "warm_step_s_median": float(sorted(warm)[len(warm) // 2]) if warm else None,
        "steps_logged": len(seconds),
        "test_render_s": grab(r"test render: ([\d.]+)s"),
        "export_s": grab(r"(?<!renders and )export: ([\d.]+)s"),
        "setup_train_test_export_s": grab(r"setup, training, test renders and export: "
                                          r"([\d.]+)s"),
    }


def fingerprint(trial: str) -> dict:
    """Mean RGB and sha256 prefix of the last test render's view 0."""
    import numpy as np
    from PIL import Image

    save = os.path.join(trial, "save")
    tests = sorted((d for d in os.listdir(save) if d.startswith("it") and d.endswith("-test")
                    and os.path.isdir(os.path.join(save, d))),
                   key=lambda d: int(d[2:-5])) if os.path.isdir(save) else []
    if not tests:
        return {}
    png = os.path.join(save, tests[-1], "0.png")
    arr = np.asarray(Image.open(png))
    return {
        "file": os.path.relpath(png, REPO),
        "mean_rgb": [round(float(c), 3) for c in arr[..., :3].reshape(-1, 3).mean(0)],
        "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
    }


def _text(x) -> str:
    if x is None:
        return ""
    return x.decode(errors="replace") if isinstance(x, bytes) else x


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--views", type=int, default=8,
                    help="fixed prerender views (128 in the reference's rig)")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--mesh", default=APPLE)
    ap.add_argument("--config", default="configs/dreammat.yaml")
    ap.add_argument("--out", default="reports/e2e_torch.json")
    ap.add_argument("--tag", default="e2e_evidence")
    ap.add_argument("--exp-root-dir", default="outputs",
                    help="the runs' root (relative to the repository)")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds allowed to the run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("overrides", nargs="*",
                    help="more key=value overrides, after the tool's own")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from dreammat_tpu_torch.utils.hw import resolve_device

    resolve_device(args.device)
    if not os.path.exists(os.path.join(REPO, args.mesh)):
        raise FileNotFoundError(f"no mesh at {args.mesh} (pass --mesh PATH)")
    trial_root = os.path.join(REPO, args.exp_root_dir)
    trial = os.path.join(trial_root, "dream_mat", args.tag)
    cmd = launch_argv(args, trial_root)
    failed = None
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=args.timeout)
        log = _text(proc.stdout) + _text(proc.stderr)
        if proc.returncode != 0:
            failed = proc.returncode
    except subprocess.TimeoutExpired as e:
        log = _text(e.stdout) + _text(e.stderr)
        failed = "timeout"
    wall = time.time() - t0
    sys.stdout.write(log[-4000:])

    export_dir = os.path.join(trial, "save", "export")
    row = {
        "artifact": "e2e_evidence_torch", "date": time.strftime("%Y-%m-%d"),
        "cmd": " ".join(cmd[1:]), "device": args.device,
        "resolution": args.res, "views": args.views, "steps": args.steps,
        "total_wall_s": round(wall, 1),
        "phases": parse_phases(log, trial),
        "phase_notes": {"static_maps_s": STATIC_MAPS_NOTE},
        "render_fingerprint": fingerprint(trial),
        "export_files": sorted(os.listdir(export_dir)) if os.path.isdir(export_dir) else [],
        "weights": "random-init (no trained SD weights)",
    }
    if failed is not None:
        row["failed"] = failed
        row["log_tail"] = log[-4000:]
        if failed == "timeout":
            row["timeout_s"] = args.timeout
    out = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(row, fh, indent=1)
    print(f"\n[e2e_torch] wrote {args.out}")
    if failed is not None:
        print(f"[e2e_torch] launch_torch.py FAILED: {failed}")
        return 1
    print(json.dumps(row["phases"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
