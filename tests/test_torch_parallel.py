"""Port parity: ``dreammat_tpu_torch/parallel/`` and the code wired through it,
at world size 2 over gloo on the CPU, against the JAX package's
``parallel/`` on the conftest's virtual CPU devices.

One two-rank group runs per module (``tests/torch_parallel_worker.py``,
spawned with ``torch.multiprocessing``; torch and the port only, one thread
a rank) while JAX computes the references here. Tolerances:

- the mesh's axes and rank order, ``shard_batch`` and the rank-0 files:
  exact;
- ``shard_rays`` against the local call and the JAX package's
  ``shard_rays`` (R = 37 over 2 ranks, padded to 38), output and gradient:
  1e-6 abs (each row is computed once, by one rank);
- the tensor-parallel tiny UNet against the JAX UNet (replicated) on the
  same weights, output and input gradient: relative L2 1e-4 (fp32; the
  split changes the order of the projections' sums), and a UNet whose
  1-head blocks stay replicated against its own unsplit output: 1e-5;
- one DDP ControlNet step on a (2, 1) and on a (1, 2) mesh against the JAX
  step on a (data=2, model=1) mesh: loss 1e-4 relative, parameters after
  the clipped AdamW update 1e-5 abs (the tolerances of
  ``tests/test_torch_controlnet_trainer.py``); both ranks bitwise equal;
- an eval view's shading through ``shard_rays`` against the local render:
  1e-6 abs.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import torch_parallel_worker
from dreammat_tpu_torch.data import prerender as tpr
from dreammat_tpu_torch.models.diffusion import convert
from torch_threads import one_thread  # noqa: F401

# AdamW's eps at 1e-6: its first step, lr * g / (|g| + eps), would turn the
# rounding of gradients that are zero analytically (a conv bias before a
# GroupNorm of one channel a group) into updates near lr at eps = 1e-8
TRAIN_CFG = {"model_size": "tiny", "resolution": 16, "train_batch_size": 2,
             "num_train_epochs": 1, "checkpointing_steps": 0, "learning_rate": 1e-4,
             "adam_epsilon": 1e-6}
JOBS = [{"mesh": f"mesh{i}.obj", "prompt": f"job {i}", "max_steps": 1} for i in range(3)]
DREAMMAT_OVERRIDES = [
    "system.prompt_processor.prompt=a red apple",
    "system.geometry.shape_init=procedural:sphere",
    "system.geometry.shape_init_params=2",
    "system.material.use_prefiltered=true",
    "data.fix_view_num=2",
    "data.cond_height=16",
    "data.cond_width=16",
    "data.fastpath_check=false",
    "data.static_field_maps=false",
]


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _write_dataset(root, res=16, n_views=16, n_envs=5):
    rng = np.random.RandomState(0)
    os.makedirs(root / "obj1", exist_ok=True)
    np.savez(root / "obj1" / "data.npz",
             colors=rng.rand(n_views, n_envs, res, res, 3).astype(np.float16),
             depths=rng.rand(n_views, res, res, 1).astype(np.float16),
             normals=rng.rand(n_views, res, res, 3).astype(np.float16),
             lightmaps=rng.rand(n_views, n_envs, res, res, 18).astype(np.float16))
    pf = root / "prompts.json"
    pf.write_text(json.dumps({"obj1": "a shiny robot"}))
    return str(pf)


def _port_trainer_state():
    """The port trainer's modules with every matrix and kernel drawn anew
    from a seeded normal of variance 1 / fan-in (flax's default; the port's
    random init, normal 0.02, leaves the ControlNet's first layers
    gradients near AdamW's eps, where its first step turns on the
    gradient's last digits). That also fills the kernels the trainer zeroes
    (the ControlNet's output convs), so the gradient reaches every layer."""
    from dreammat_tpu_torch.systems.controlnet_trainer import ControlNetTrainer

    tr = ControlNetTrainer(dict(TRAIN_CFG), device="cpu")
    tr.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(7)
    state = {}
    for kind in ("unet", "vae", "clip", "controlnet"):
        sd = getattr(tr, kind).state_dict()
        for k, v in sd.items():
            if k.endswith("weight") and v.ndim > 1:
                std = 1.0 / np.sqrt(np.prod(v.shape[1:]))
                sd[k] = torch.from_numpy(rng.normal(0, std, v.shape).astype(np.float32))
        state[kind] = sd
    return state


def _jax_trainer_params(jax, jtr, state):
    """``state`` as the JAX trainer's ``init_params`` tree: each module's
    template from ``jax.eval_shape`` of its init (the shapes of
    ``ControlNetTrainer.init_params``), filled by the JAX package's
    ``torch_to_flax_params``."""
    from dreammat_tpu.models.diffusion import convert as jconvert

    jnp = jax.numpy
    res = TRAIN_CFG["resolution"]
    lat = res // jtr.vae_factor
    k = jax.random.PRNGKey(0)
    sample, t = jnp.zeros((1, lat, lat, 4)), jnp.zeros((1,))
    ctx = jnp.zeros((1, jtr.clip_cfg.max_length, jtr.unet_cfg.cross_attention_dim))
    stem = 2 ** (len(jtr.controlnet.cfg.conditioning_embedding_channels) - 1)
    shapes = {
        "unet": jax.eval_shape(jtr.unet.init, k, sample, t, ctx),
        "vae": jax.eval_shape(jtr.vae.init, k, jnp.zeros((1, res, res, 3))),
        "clip": jax.eval_shape(jtr.clip.init, k,
                               jnp.zeros((1, jtr.clip_cfg.max_length), jnp.int32)),
        "controlnet": jax.eval_shape(jtr.controlnet.init, k, sample, t, ctx,
                                     jnp.zeros((1, lat * stem, lat * stem, 22))),
    }
    p = {kind: _np(jconvert.torch_to_flax_params(state[kind], shapes[kind], kind))
         for kind in shapes}
    return {"frozen": {kind: p[kind] for kind in ("unet", "vae", "clip")},
            "controlnet": p["controlnet"]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written, the two ranks run, and the JAX references computed
    meanwhile."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import dreammat_tpu
    import dreammat_tpu.systems  # noqa: F401  (registry)
    from dreammat_tpu.parallel import mesh as jmesh

    io = tmp_path_factory.mktemp("parallel")
    os.makedirs(io / "shared")
    rng = np.random.RandomState(0)
    inputs = {"batch_x": rng.normal(size=(4, 3)).astype(np.float32),
              "rays_x": rng.normal(size=(37, 4)).astype(np.float32),
              "rays_y": rng.normal(size=(37, 4)).astype(np.float32),
              "rays_w": rng.normal(size=(37, 4)).astype(np.float32)}
    np.savez(io / "inputs.npz", **inputs)

    # the ControlNet trainer's weights (its tiny UNet also the tensor-parallel
    # case's), the UNet's inputs, the batch and the JAX keys' draws
    state = _port_trainer_state()
    torch.save(state, io / "trainer_state.pt")
    torch.save(state["unet"], io / "unet_state.pt")
    (io / "trainer_cfg.json").write_text(json.dumps(TRAIN_CFG))
    unet_in = {"sample": rng.normal(size=(2, 8, 8, 4)).astype(np.float32),
               "t": np.array([10, 700], np.int64),
               "ctx": rng.normal(size=(2, 6, 64)).astype(np.float32),
               "w": rng.normal(size=(2, 8, 8, 4)).astype(np.float32)}
    np.savez(io / "unet_inputs.npz", **unet_in)
    jtr = dreammat_tpu.find("controlnet-trainer")(dict(TRAIN_CFG))
    B, res = TRAIN_CFG["train_batch_size"], TRAIN_CFG["resolution"]
    batch = {"target": rng.uniform(size=(B, res, res, 3)).astype(np.float32),
             "condition": rng.uniform(size=(B, res, res, 22)).astype(np.float32),
             "prompts": ["a red apple", ""]}
    key = jax.random.PRNGKey(1)
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    lat = res // jtr.vae_factor
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    draws = {"vae_eps": nchw(jax.random.normal(k_enc, (B, lat, lat, 4))),
             "t": np.asarray(jax.random.randint(
                 k_t, (B,), 0, jtr.schedule["alphas_cumprod"].shape[0])).astype(np.int64),
             "noise": nchw(jax.random.normal(k_noise, (B, lat, lat, 4)))}
    np.savez(io / "step_inputs.npz", prompts=np.array(batch["prompts"]),
             target=batch["target"], condition=batch["condition"], **draws)

    pf = _write_dataset(io / "data")
    (io / "train_cfg.json").write_text(json.dumps({
        **TRAIN_CFG, "train_data_dir": str(io / "data"), "prompt_file_path": pf,
        "controlnet_dir": str(io / "shared" / "controlnet"), "sd_cache_dir": None}))
    (io / "jobs.json").write_text(json.dumps(JOBS))
    (io / "dreammat_overrides.json").write_text(json.dumps(DREAMMAT_OVERRIDES))

    ctx = tmp.start_processes(torch_parallel_worker.run,
                              args=(2, str(io / "init"), str(io)), nprocs=2, join=False,
                              start_method="spawn")
    try:
        tparams = _jax_trainer_params(jax, jtr, state)
        # the JAX references, while the ranks run
        devices = jax.devices()[:2]
        meshes = {s: jmesh.make_mesh(*s, devices=devices) for s in ((2, 1), (1, 2))}
        ref = {"mesh": {s: [[d.id for d in row] for row in np.asarray(m.devices)]
                        for s, m in meshes.items()}}
        xs = jmesh.shard_batch(meshes[(2, 1)], jnp.asarray(inputs["batch_x"]))
        ref["shards"] = {s.device.id: np.asarray(s.data) for s in xs.addressable_shards}

        fn = lambda x, y: jnp.sin(x) * y + x * x
        y, w = jnp.asarray(inputs["rays_y"]), jnp.asarray(inputs["rays_w"])
        ref["rays_out"] = np.asarray(jmesh.shard_rays(meshes[(2, 1)], fn,
                                                      jnp.asarray(inputs["rays_x"]), y))
        ref["rays_grad"] = np.asarray(jax.grad(
            lambda x: jnp.sum(jmesh.shard_rays(meshes[(2, 1)], fn, x, y) * w))(
                jnp.asarray(inputs["rays_x"])))

        ref["unet_out"] = np.asarray(jax.jit(jtr.unet.apply)(
            tparams["frozen"]["unet"], *(jnp.asarray(unet_in[k]) for k in ("sample", "t", "ctx"))))

        jb = {"target": jnp.asarray(batch["target"]),
              "condition": jnp.asarray(batch["condition"]),
              "input_ids": jnp.asarray(jtr.tokenizer.batch(batch["prompts"]))}
        step_fn = jtr.make_train_step(meshes[(2, 1)])
        cnet = tparams["controlnet"]
        new, _, metrics = step_fn(cnet, jtr.tx.init(cnet), tparams["frozen"], jb, key)
        ref["step_loss"] = float(metrics["loss"])
        ref["step_new"] = convert.flax_to_torch_state_dict(_np(new), "controlnet")
        ref["jax_process"] = (jax.process_index(), jax.process_count())
        while not ctx.join(timeout=600):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [torch.load(io / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return types.SimpleNamespace(io=io, ranks=ranks, ref=ref, inputs=inputs)


def test_mesh_axes_and_rank_order(run):
    for shape in ((2, 1), (1, 2)):
        for r, res in enumerate(run.ranks):
            m = res[f"mesh_{shape[0]}x{shape[1]}"]
            assert m["shape"] == {"data": shape[0], "model": shape[1]}
            assert m["ranks"] == run.ref["mesh"][shape]   # data-major, as the JAX mesh
            assert m["ranks"][m["data_index"]][m["model_index"]] == r
    assert run.ranks[0]["world"] == run.ranks[1]["world"] == 2


def test_shard_batch_round_trips(run):
    x = run.inputs["batch_x"]
    parts = [res["shard_batch"] for res in run.ranks]
    for r, part in enumerate(parts):
        assert np.array_equal(part["x"].numpy(), run.ref["shards"][r])
    assert np.array_equal(torch.cat([p["x"] for p in parts]).numpy(), x)
    assert sum((p["prompts"] for p in parts), []) == [f"p{i}" for i in range(len(x))]
    for res in run.ranks:  # a (1, 2) mesh has one data block: every rank holds the batch
        assert np.array_equal(res["shard_batch_model"]["x"].numpy(), x)
        # replicated: rank 0's values on every rank
        assert torch.equal(res["replicated"]["w"], torch.ones(3))


def test_shard_rays_matches_local_and_jax(run):
    for res in run.ranks:
        got, local = res["shard_rays"]["sharded"], res["shard_rays"]["local"]
        assert got["out"].shape == (37, 4)
        for k in ("out", "grad"):
            assert float((got[k] - local[k]).abs().max()) <= 1e-6, k
        assert np.abs(got["out"].numpy() - run.ref["rays_out"]).max() <= 1e-6
        assert np.abs(got["grad"].numpy() - run.ref["rays_grad"]).max() <= 1e-6


def test_tp_unet_matches_jax_replicated(run):
    for res in run.ranks:
        tp = res["tp_tiny"]
        assert tp["layers_split"] == tp["splittable"] > 0
        assert all(split for _, split in tp["heads_split"])
        for side in ("replicated", "split"):
            assert _rel(tp[side]["out"], run.ref["unet_out"]) < 1e-4, side
        # the backward through the split (Megatron's f and g) against the unsplit one
        assert _rel(tp["split"]["grad"], tp["replicated"]["grad"]) < 1e-5
    assert torch.equal(run.ranks[0]["tp_tiny"]["split"]["out"],
                       run.ranks[1]["tp_tiny"]["split"]["out"])


def test_tp_keeps_indivisible_heads_replicated(run):
    for res in run.ranks:
        tp = res["tp_mixed"]
        # 1-head attentions stay whole, 2-head ones split one head a rank
        assert sorted(set(tp["heads_split"])) == [(1, False), (2, True)]
        for k in ("out", "grad"):
            assert float((tp["split"][k] - tp["replicated"][k]).abs().max()) <= 1e-5, k


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_ddp_step_matches_jax_mesh_step(run, shape):
    rs = [res[f"ddp_{shape}"] for res in run.ranks]
    want = run.ref["step_new"]
    for res in rs:
        assert abs(res["loss"] - run.ref["step_loss"]) <= 1e-4 * abs(run.ref["step_loss"])
        assert res["grad_allreduces"] >= 1
        assert sorted(res["controlnet"]) == sorted(want)
        for k, v in res["controlnet"].items():
            assert float((v - want[k]).abs().max()) <= 1e-5, k
    for res in rs[1:]:
        for k, v in rs[0]["controlnet"].items():
            assert torch.equal(v, res["controlnet"][k]), k


def test_n_model_two_trains_under_a_two_rank_group(run):
    r0, r1 = (res["n_model"] for res in run.ranks)
    assert r0["step"] == r1["step"] == 2 and r0["mesh"] == {"data": 1, "model": 2}
    assert all(np.isfinite(r0["losses"])) and r0["losses"] == r1["losses"]
    assert r0["grad_allreduces"] >= 2 and r0["checksum"] == r1["checksum"]
    with open(run.io / "shared" / "controlnet" / "logs" / "metrics.csv") as f:
        assert len(f.read().strip().splitlines()) == 3


def test_rank_zero_fill_checkpoint_and_caches_written_once(run):
    shared = run.io / "shared"
    assert (shared / "fill_calls.txt").read_text() == "0\n"
    for res in run.ranks:
        assert res["fill"] == [True, True]
        # rank 0 wrote its own values; rank 1 read them back
        assert torch.equal(res["ckpt"]["w"], torch.zeros(3)) and res["ckpt"]["step"] == 3
    p0, p1 = (res["prompt"] for res in run.ranks)
    assert p0["hits"] == 0 and p1["hits"] == 3 and torch.equal(p0["emb"], p1["emb"])
    c0, c1 = (res["prerender"] for res in run.ranks)
    assert not c0["from_cache"] and c1["from_cache"]
    assert len(os.listdir(shared / "prerender")) == 1
    # rank 1 holds rank 0's maps as the cache quantizes them
    lm, _, nrm = tpr.quantize_for_cache(c0["lightmaps"], c0["depths"], c0["normals"])
    for got, q in ((c1["lightmaps"], lm), (c1["normals"], nrm)):
        assert torch.equal(got, (q.float() / 255.0).half())
    assert torch.equal(c1["table_spec"], c0["table_spec"])


def test_shard_rays_of_an_eval_render(run):
    for res in run.ranks:
        r = res["render"]
        assert r["pixels"] > 0 and r["sharded"].shape == r["local"].shape
        assert float((r["sharded"] - r["local"]).abs().max()) <= 1e-6
    assert torch.equal(run.ranks[0]["render"]["sharded"], run.ranks[1]["render"]["sharded"])


def test_batch_generate_shards_jobs_over_the_group(run):
    ran = {}
    for r, res in enumerate(run.ranks):
        for argv, count, rank_zero in res["batch_jobs"]:
            # each job alone: no barrier of another rank's job
            assert count == 1 and rank_zero and "--device" in argv
            ran.setdefault(next(a for a in argv if a.startswith("system.prompt_processor.prompt=")),
                           []).append(r)
    assert ran == {f"system.prompt_processor.prompt=job {i}": [i % 2] for i in range(3)}


def test_batch_generate_explicit_shard_and_environment(tmp_path, monkeypatch):
    import batch_generate_torch
    import launch_torch

    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps(JOBS))
    ran = []
    monkeypatch.setattr(launch_torch, "main", lambda argv: ran.append(argv))
    batch_generate_torch.main(["--jobs", str(jobs), "--shard", "1/2", "--device", "cpu",
                               "--out", str(tmp_path)])
    assert [a for argv in ran for a in argv if "prompt=" in a] == \
        ["system.prompt_processor.prompt=job 1"]
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DREAMMAT_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="several processes"):
        batch_generate_torch.main(["--jobs", str(jobs), "--device", "cpu"])


def test_maybe_initialize_without_environment(run, monkeypatch, tmp_path):
    import torch.distributed as tdist

    from dreammat_tpu_torch.parallel import distributed as dist

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "DREAMMAT_MULTIHOST", "SLURM_PROCID"):
        monkeypatch.delenv(name, raising=False)
    assert dist.maybe_initialize("cpu") == (0, 1) == run.ref["jax_process"]
    assert not tdist.is_initialized()
    assert dist.process_count() == 1 and dist.is_rank_zero()
    dist.barrier("test")
    calls = []
    path = str(tmp_path / "artifact")
    assert dist.rank_zero_fill(path, lambda: (calls.append(1), open(path, "w").close()))
    assert dist.rank_zero_fill(path, lambda: calls.append(2)) and calls == [1]
    assert dist.local_device("cpu") == torch.device("cpu")

    # SLURM's variables name the rank, the world and the local rank
    for name, value in (("DREAMMAT_MULTIHOST", "1"), ("SLURM_PROCID", "3"),
                        ("SLURM_NTASKS", "8"), ("SLURM_LOCALID", "1"),
                        ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(name, value)
    try:
        assert dist._cluster_env() == (3, 8, 1)
        assert (os.environ["RANK"], os.environ["WORLD_SIZE"]) == ("3", "8")
    finally:
        for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(name, None)
