"""Batch material generation on the PyTorch/CUDA port: many (mesh, prompt)
jobs, one process per GPU.

    torchrun --nproc_per_node=N batch_generate_torch.py --jobs jobs.json \
        [--config configs/dreammat.yaml] [--out outputs/batch] [key=value ...]
    python batch_generate_torch.py --jobs jobs.json --shard i/n [--device cuda:i] ...

Counterpart of ``batch_generate.py``. Each mesh fits one card, so the
scale-out is data parallelism over meshes: process i of n runs jobs i,
i + n, ... Without ``--shard``, (i, n) is the process's (rank, world size)
in the process group (torchrun's variables, or SLURM's with
``DREAMMAT_MULTIHOST=1``); the run raises where the environment asks for
several processes and the group has one. Each job is a
``launch_torch.main(["--train", ...])`` on this rank's device
(``cuda:LOCAL_RANK`` for the default ``--device cuda``), run alone
(``distributed.independent``): its caches, checkpoints and barriers are its
own, since another rank runs another job. Job i writes its trial under
``<out>/<name>/<tag>@job<i>`` (the config's tag, the job's index in place of
the timestamp), so two jobs of one prompt keep two trials. Arguments it
does not know go to ``launch_torch.py``.

jobs.json: [{"mesh": "path.obj", "prompt": "...", "scale": 0.8,
             "max_steps": 3000}, ...]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--config", default="configs/dreammat.yaml")
    ap.add_argument("--out", default="outputs/batch")
    ap.add_argument("--shard", default=None, help="i/n; default from the process group")
    ap.add_argument("--device", default="cuda", help="cuda (default: cuda:LOCAL_RANK), cuda:N or cpu")
    args, extras = ap.parse_known_args(argv)

    import dreammat_tpu_torch
    import launch_torch
    from dreammat_tpu_torch.parallel import distributed as dist

    if args.shard:
        shard_i, shard_n = (int(x) for x in args.shard.split("/"))
    else:
        shard_i, shard_n = dist.maybe_initialize(args.device)
        if shard_n == 1 and (int(os.environ.get("WORLD_SIZE", "1")) > 1
                             or os.environ.get("DREAMMAT_MULTIHOST")):
            raise RuntimeError("the environment asks for several processes but the process "
                               "group has one; pass --shard i/n or fix the environment")

    with open(args.jobs) as f:
        jobs = json.load(f)
    results = []
    for i, job in enumerate(jobs):
        if i % shard_n != shard_i:
            continue
        dreammat_tpu_torch.info("[job %d/%d, shard %d/%d] %s :: %s", i + 1, len(jobs), shard_i,
                                shard_n, job["mesh"], job["prompt"])
        job_argv = [
            "--config", args.config, "--train", "--device", args.device,
            f"system.prompt_processor.prompt={job['prompt']}",
            f"system.geometry.shape_init=mesh:{job['mesh']}",
            f"system.geometry.shape_init_params={job.get('scale', 0.9)}",
            f"trainer.max_steps={job.get('max_steps', 3000)}",
            f"exp_root_dir={args.out}",
            "use_timestamp=false",
            f"timestamp=@job{i}",
        ] + extras
        with dist.independent():
            results.append(launch_torch.main(job_argv))
    return results


if __name__ == "__main__":
    main()
