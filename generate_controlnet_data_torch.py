"""ControlNet training-data generation with the PyTorch/CUDA port.

The command line of ``generate_controlnet_data.py`` on
``dreammat_tpu_torch``: per mesh (.obj, .glb, .ply) of ``--meshes-dir``, the
depth, normal and light-probe condition maps of ``--views`` fixed cameras
under the ``--envs`` environment maps of ``--env-dir``
(``map{i}/map{i}.{exr,hdr}``; procedural skies where none exists) and the
colour targets of a constant material, written as
``<out>/<mesh name>/data.npz``, the layout ``ControlNetDataset`` reads, with
``<out>/prompts.json``:

    python generate_controlnet_data_torch.py --meshes-dir path/to/meshes \\
        --prompts prompts.json --out dataset/training_data \\
        [--views 16 --envs 5 --resolution 256] [--shard 0/1] [--device cuda]

prompts.json: {"mesh_name_without_ext": "a prompt", ...}; a mesh without an
entry gets its file stem as prompt. Runs on the card (``--device``, default
``cuda``); without one it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes-dir", required=True)
    ap.add_argument("--prompts", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--envs", type=int, default=5)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--env-dir", default="load/lights/envmap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard", default="0/1", help="i/n: process jobs where idx%%n==i")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import dreammat_tpu_torch
    from dreammat_tpu_torch.data.controlnet_dataset import generate_dataset_for_mesh
    from dreammat_tpu_torch.utils.hw import resolve_device

    device = resolve_device(args.device)
    shard_i, shard_n = (int(x) for x in args.shard.split("/"))
    meshes = sorted(
        glob.glob(os.path.join(args.meshes_dir, "*.obj"))
        + glob.glob(os.path.join(args.meshes_dir, "*.glb"))
        + glob.glob(os.path.join(args.meshes_dir, "*.ply"))
    )
    prompts = {}
    if args.prompts and os.path.exists(args.prompts):
        with open(args.prompts) as f:
            prompts = json.load(f)

    os.makedirs(args.out, exist_ok=True)
    out_prompts = {}
    written = []
    for i, mesh_path in enumerate(meshes):
        name = os.path.splitext(os.path.basename(mesh_path))[0]
        out_prompts[name] = prompts.get(name, name.replace("_", " "))
        if i % shard_n != shard_i:
            continue
        dreammat_tpu_torch.info("[%d/%d] generating %s", i + 1, len(meshes), name)
        written.append(generate_dataset_for_mesh(
            mesh_path, os.path.join(args.out, name),
            material_cfg={"environment_texture": args.env_dir, "n_environments": args.envs},
            n_views=args.views, n_envs=args.envs, resolution=args.resolution,
            seed=args.seed + i, device=device,
        ))
    with open(os.path.join(args.out, "prompts.json"), "w") as f:
        json.dump(out_prompts, f, indent=2)
    dreammat_tpu_torch.info("wrote %d prompt entries", len(out_prompts))
    return {"out": args.out, "written": written, "prompts": out_prompts}


if __name__ == "__main__":
    main()
