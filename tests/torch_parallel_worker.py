"""The ranks of ``tests/test_torch_parallel.py``: a two-rank gloo group on the
CPU that runs the port's ``parallel/`` helpers and the code wired through
them, one thread a rank. It imports torch and the port only, never JAX:
the test writes the inputs (made from a seed with numpy, and the JAX
package's weights through the port's bridge) into ``io_dir``, and each rank
writes what it computed to ``io_dir/rank{r}.pt`` for the test to hold
against the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as tdist


def _mesh_cases(rank, io):
    from dreammat_tpu_torch.parallel.mesh import make_mesh, replicated, shard_batch

    out = {"replicated": replicated(make_mesh(2, 1), {"w": torch.full((3,), float(rank + 1))})}
    for shape in ((2, 1), (1, 2)):
        m = make_mesh(*shape)
        out[f"mesh_{shape[0]}x{shape[1]}"] = {
            "ranks": m.ranks.tolist(), "shape": m.shape, "data_index": m.data_index,
            "model_index": m.model_index}
    x = torch.from_numpy(io["batch_x"])
    prompts = [f"p{i}" for i in range(len(x))]
    out["shard_batch"] = shard_batch(make_mesh(2, 1), {"x": x, "prompts": prompts})
    out["shard_batch_model"] = shard_batch(make_mesh(1, 2), {"x": x})
    return out


def _shard_rays_case(rank, io):
    from dreammat_tpu_torch.parallel.mesh import make_mesh, shard_rays

    fn = lambda x, y: torch.sin(x) * y + x * x
    w = torch.from_numpy(io["rays_w"])
    res = {}
    for name, mesh in (("sharded", make_mesh(2, 1)), ("local", None)):
        x = torch.from_numpy(io["rays_x"]).requires_grad_(True)
        y = torch.from_numpy(io["rays_y"])
        o = shard_rays(mesh, fn, x, y)
        (o * w).sum().backward()
        res[name] = {"out": o.detach(), "grad": x.grad}
    return {"shard_rays": res}


def _tp_unet_case(rank, io_dir):
    from dreammat_tpu_torch.models.diffusion.layers import (
        Attention, FeedForward, TimestepEmbedding,
    )
    from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
    from dreammat_tpu_torch.parallel.mesh import ColumnParallelLinear, make_mesh, tp_shard_params

    z = np.load(os.path.join(io_dir, "unet_inputs.npz"))
    mesh = make_mesh(1, 2)
    out = {}
    # tiny: 4 and 8 heads, all split; mixed: 1 and 2 heads, the first replicated
    for name, cfg in (("tiny", UNetConfig.tiny()),
                      ("mixed", dataclasses.replace(UNetConfig.tiny(), attention_head_dim=32))):
        torch.manual_seed(0)
        unet = UNet2DCondition(cfg).eval()
        if name == "tiny":
            unet.load_state_dict(torch.load(os.path.join(io_dir, "unet_state.pt")))
        t, ctx = torch.from_numpy(z["t"]), torch.from_numpy(z["ctx"])
        w = torch.from_numpy(z["w"])
        res = {"splittable": sum(isinstance(m, (Attention, FeedForward, TimestepEmbedding))
                                 for m in unet.modules())}
        for side in ("replicated", "split"):
            if side == "split":
                res["layers_split"] = tp_shard_params(mesh, unet)
                res["heads_split"] = sorted(
                    (m.num_heads, isinstance(m.to_q, ColumnParallelLinear))
                    for m in unet.modules() if isinstance(m, Attention))
            x = torch.from_numpy(z["sample"]).permute(0, 3, 1, 2).contiguous().requires_grad_()
            y = unet(x, t, ctx)
            (y * w.permute(0, 3, 1, 2)).sum().backward()
            res[side] = {"out": y.detach().permute(0, 2, 3, 1), "grad": x.grad.permute(0, 2, 3, 1)}
        out[f"tp_{name}"] = res
    return out


def _ddp_step_case(rank, io_dir):
    from dreammat_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from dreammat_tpu_torch.systems.controlnet_trainer import ControlNetTrainer

    with open(os.path.join(io_dir, "trainer_cfg.json")) as f:
        cfg = json.load(f)
    state = torch.load(os.path.join(io_dir, "trainer_state.pt"))
    z = np.load(os.path.join(io_dir, "step_inputs.npz"))
    batch = {"target": z["target"], "condition": z["condition"], "prompts": list(z["prompts"])}
    draws = {"vae_eps": torch.from_numpy(z["vae_eps"]), "t": torch.from_numpy(z["t"]),
             "noise": torch.from_numpy(z["noise"])}
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape)
        tr = ControlNetTrainer(dict(cfg), device="cpu")
        tr.load_state_dicts(state)
        tr.make_optimizer()
        tr.distribute(mesh)
        m = tr.train_step(shard_batch(mesh, batch), draws)
        out[f"ddp_{shape[0]}x{shape[1]}"] = {
            "loss": float(m["loss"]), "grad_allreduces": tr.grad_allreduces,
            "grad": torch.cat([p.grad.flatten() for p in tr.controlnet.parameters()]),
            "controlnet": {k: v.clone() for k, v in tr.controlnet.state_dict().items()}}
    return out


def _n_model_case(rank, io_dir):
    """``train_controlnet.main --n-model 2`` under the group: both ranks hold
    the UNet split in two and train the same ControlNet."""
    from dreammat_tpu_torch import train_controlnet

    out = train_controlnet.main(["--config", os.path.join(io_dir, "train_cfg.json"),
                                 "--max-steps", "2", "--n-model", "2"], device="cpu")
    tr = out["trainer"]
    return {"n_model": {"step": out["step"], "losses": out["losses"],
                        "mesh": tr.mesh.shape, "grad_allreduces": tr.grad_allreduces,
                        "checksum": float(sum(p.double().sum() for p in tr.controlnet.parameters()))}}


def _rank_zero_cases(rank, io_dir):
    import batch_generate_torch
    import launch_torch
    from dreammat_tpu_torch.parallel import distributed as dist
    from dreammat_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint

    out = {}
    shared = os.path.join(io_dir, "shared")
    calls = os.path.join(shared, "fill_calls.txt")

    def fill():
        with open(calls, "a") as f:
            f.write(f"{rank}\n")
        with open(os.path.join(shared, "artifact"), "w") as f:
            f.write("x")

    out["fill"] = [dist.rank_zero_fill(os.path.join(shared, "artifact"), fill, "test")
                   for _ in range(2)]
    path = save_checkpoint(os.path.join(shared, "ckpt", "step3"),
                           {"w": torch.full((3,), float(rank))}, None, 3)
    sd, _, step = load_checkpoint(path)
    out["ckpt"] = {"w": sd["w"], "step": step}

    # batch generation: each rank its shard of the jobs, each job alone
    ran = []
    real = launch_torch.main
    launch_torch.main = lambda argv: ran.append(
        (argv, dist.process_count(), dist.is_rank_zero()))
    try:
        batch_generate_torch.main(["--jobs", os.path.join(io_dir, "jobs.json"),
                                   "--out", os.path.join(shared, "batch"), "--device", "cpu"])
    finally:
        launch_torch.main = real
    out["batch_jobs"] = ran
    return out


def _dreammat_cases(rank, io_dir):
    """The prompt cache and the prerender cache filled by rank 0 and read by
    rank 1, then ``shard_rays`` of an eval view against the local render."""
    import chip_smoke
    import dreammat_tpu_torch
    import dreammat_tpu_torch.data  # noqa: F401 (registry)
    import dreammat_tpu_torch.models  # noqa: F401
    import dreammat_tpu_torch.systems  # noqa: F401
    from dreammat_tpu_torch.parallel.mesh import make_mesh, shard_rays
    from dreammat_tpu_torch.utils.config import load_config

    with open(os.path.join(io_dir, "dreammat_overrides.json")) as f:
        cfg = load_config("configs/dreammat_tiny.yaml", json.load(f))
    shared = os.path.join(io_dir, "shared")
    pp = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(
        dict(cfg.system["prompt_processor"], use_cache=True,
             cache_dir=os.path.join(shared, "text_embeddings")), device="cpu")
    emb = pp.encode_prompts(["a red apple", "a blue ball", ""])
    out = {"prompt": {"hits": pp.cache_hits, "emb": emb}}

    system = dreammat_tpu_torch.find(cfg.system_type)(cfg.system, device="cpu")
    dm = dreammat_tpu_torch.find(cfg.data_type)(
        dict(cfg.data, prerender_cache_dir=os.path.join(shared, "prerender")),
        system.renderer, system.material, device="cpu")
    dm.setup()
    out["prerender"] = {"from_cache": dm.data.from_cache,
                        **{k: getattr(dm.data, k)
                           for k in ("lightmaps", "depths", "normals", "table_spec")}}
    system.init_state(0)
    fn, args = chip_smoke.eval_colors(system, dm.eval_view(0))
    with torch.no_grad():
        out["render"] = {"sharded": shard_rays(make_mesh(2, 1), fn, *args),
                         "local": fn(*args), "pixels": args[0].shape[0]}
    return out


def run(rank: int, world: int, init_file: str, io_dir: str) -> None:
    """Rank ``rank`` of the group: every case, in order, then its results."""
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world)
    try:
        io = dict(np.load(os.path.join(io_dir, "inputs.npz")))
        out = {"world": tdist.get_world_size(), "seconds": {}}
        for case, arg in ((_mesh_cases, io), (_shard_rays_case, io), (_tp_unet_case, io_dir),
                          (_ddp_step_case, io_dir), (_n_model_case, io_dir),
                          (_rank_zero_cases, io_dir), (_dreammat_cases, io_dir)):
            t0 = time.time()
            out.update(case(rank, arg))
            out["seconds"][case.__name__] = time.time() - t0
        torch.save(out, os.path.join(io_dir, f"rank{rank}.pt"))
    finally:
        tdist.destroy_process_group()
