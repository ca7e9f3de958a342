"""Command-line entry point of the PyTorch/CUDA port (``dreammat_tpu_torch``).

The flag surface of ``launch.py``:

    python launch_torch.py --config configs/dreammat.yaml --train \
        system.geometry.shape_init=mesh:<mesh>.obj system.prompt_processor.prompt="..."

``--train`` runs the datamodule's setup (prerender, fast-path gate), ``fit``,
the test renders of the eval circle and the OBJ/MTL export; the volume
systems (``configs/dreamfusion.yaml``, ``configs/prolificdreamer.yaml``)
have no prerender, render their test views by volume rendering and export
the density isosurface as an OBJ with vertex colours, and the DMTet systems
(``configs/fantasia3d.yaml``, Magic3D's refinement, ProlificDreamer's
``geometry`` and ``texture`` stages) the same through the mesh rasterizer
and the SDF's level set, and the rest of the volume family (Latent-NeRF and
SJC from ``configs/sjc_tiny.yaml`` with ``system_type`` and blocks replaced,
the patch renderer; TextMesh from ``configs/textmesh.yaml``, NeuS over the
implicit SDF) the same as the NeRF volume;
``--validate`` / ``--test`` / ``--export`` run one of them from a
checkpoint given by ``--resume``. A UV-space field
(``system.geometry.n_input_dims=2``) cannot be exported (the reference
queries the field at 3D texel positions): ``--train`` then skips the export
with a warning, and ``--export`` raises. Dotted ``key=value`` arguments override the
config. The trial directory receives ``cmd.txt`` and ``parsed.yaml``.

Devices: ``--device`` (default ``cuda``) places everything; ``--gpu N``
selects ``cuda:N``. Without a GPU the run raises unless ``--device cpu`` is
given. Under torchrun (or SLURM with ``DREAMMAT_MULTIHOST=1``) each process
joins the process group (NCCL on the card) on ``cuda:LOCAL_RANK`` unless
``--gpu`` or ``--device`` names another; rank 0 alone writes ``cmd.txt`` and
``parsed.yaml``, checkpoints and the shared caches. ``--typecheck`` turns on ``torch.autograd.set_detect_anomaly``;
``--profile-dir`` writes a ``torch.profiler`` trace of the setup.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import time


def _profiled(profile_dir):
    """A ``torch.profiler`` context exporting a Chrome trace into
    ``profile_dir``, or a no-op without one."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch

    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="path to config yaml")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--export", action="store_true")
    parser.add_argument("--resume", default=None, help="checkpoint (.pt) to resume from")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--typecheck", action="store_true",
                        help="torch.autograd.set_detect_anomaly(True)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the setup into this dir")
    parser.add_argument("--gpu", default=None, help="GPU index: selects cuda:N")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args, extras = parser.parse_known_args(argv)
    if not (args.train or args.validate or args.test or args.export):
        parser.error("specify one of --train / --validate / --test / --export")

    import torch

    import dreammat_tpu_torch
    import dreammat_tpu_torch.data  # noqa: F401 (registry)
    import dreammat_tpu_torch.models  # noqa: F401
    import dreammat_tpu_torch.systems  # noqa: F401
    from dreammat_tpu_torch.parallel import distributed as dist
    from dreammat_tpu_torch.utils.config import load_config

    device = args.device
    if args.gpu is not None and device == "cuda":
        device = f"cuda:{int(args.gpu)}"
    # the reference's Lightning DDP plumbing (launch.py:44-59); no-op in one process
    device = dist.local_device(device)
    rank, world = dist.maybe_initialize(device)
    if args.verbose:
        import logging

        dreammat_tpu_torch.logger.setLevel(logging.DEBUG)
    if args.typecheck:
        torch.autograd.set_detect_anomaly(True)

    cfg = load_config(args.config, cli_args=extras)
    dreammat_tpu_torch.info("device: %s (rank %d of %d)", device, rank, world)
    dreammat_tpu_torch.info("trial dir: %s", cfg.trial_dir)
    os.makedirs(cfg.trial_dir, exist_ok=True)
    if dist.is_rank_zero():
        with open(os.path.join(cfg.trial_dir, "cmd.txt"), "w") as f:
            f.write(" ".join(["python"] + (sys.argv if argv is None
                                           else ["launch_torch.py", *argv])) + "\n")
        shutil.copy(args.config, os.path.join(cfg.trial_dir, "parsed.yaml"))

    find = dreammat_tpu_torch.find
    system = find(cfg.system_type)(cfg.system, device=device)
    datamodule = find(cfg.data_type)(cfg.data, system.renderer, system.material, device=device)

    if args.resume:
        from dreammat_tpu_torch.utils.ckpt import load_checkpoint

        state_dict, opt_state, step = load_checkpoint(args.resume, device=device)
        system.init_state(cfg.seed)
        system.load_state(state_dict, opt_state, step)
        dreammat_tpu_torch.info("resumed from %s at step %d", args.resume, step)
    elif not args.train:
        parser.error("--validate / --test / --export need --resume")

    if args.train:
        t_run = time.time()
        with _profiled(args.profile_dir):
            datamodule.setup()
        system.fit(datamodule, max_steps=cfg.trainer.max_steps, seed=cfg.seed,
                   trial_dir=cfg.trial_dir, val_check_interval=cfg.trainer.val_check_interval,
                   checkpoint_every=cfg.checkpoint.every_n_train_steps)
        t0 = time.time()
        system.test(datamodule, cfg.trial_dir, cfg.trainer.max_steps)
        dreammat_tpu_torch.info("test render: %.1fs", time.time() - t0)
        if system.geometry.cfg.n_input_dims == 3:
            t0 = time.time()
            system.export(cfg.trial_dir)
            dreammat_tpu_torch.info("export: %.1fs", time.time() - t0)
        else:
            from dreammat_tpu_torch.models.exporter import UV_FIELD_EXPORT

            dreammat_tpu_torch.warn("export skipped: %s", UV_FIELD_EXPORT)
        dreammat_tpu_torch.info("setup, training, test renders and export: %.1fs",
                                time.time() - t_run)
    elif args.validate:
        datamodule.setup()
        system.validation(datamodule, cfg.trial_dir, system.global_step)
    elif args.test:
        system.test(datamodule, cfg.trial_dir, system.global_step)
    else:
        system.export(cfg.trial_dir)
    return {"cfg": cfg, "system": system, "datamodule": datamodule, "trial_dir": cfg.trial_dir}


if __name__ == "__main__":
    main()
