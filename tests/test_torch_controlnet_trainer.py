"""Port parity: ControlNet training (dataset, scheduler, from_unet, one train
step, fit and export) against the JAX package, at the tiny config on the CPU.

The JAX trainer's ``init_params`` tree goes through the port's weight bridge
(``convert.controlnet_trainer_state_from_flax``) into the port trainer, and
the JAX keys' draws (VAE posterior noise, t, latent noise) are handed to the
port's ``train_step``. Tolerances: loss 1e-4 relative, ControlNet gradient
1e-3 relative L2, parameters after the clipped AdamW update 1e-5 abs; the
dataset and ``from_unet`` bitwise; DDIM 1e-6 abs. The ControlNet's
zero-initialized output convs and the UNet's zero-initialized conv_out are
perturbed (seeded numpy noise, the same on both sides) so that the gradient
reaches every ControlNet layer.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from dreammat_tpu_torch.data.controlnet_dataset import ControlNetDataset
from dreammat_tpu_torch.models.diffusion import convert
from dreammat_tpu_torch.models.diffusion import scheduler as tsched
from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition
from dreammat_tpu_torch.systems.controlnet_trainer import ControlNetTrainer, controlnet_from_unet
from dreammat_tpu_torch.utils.ckpt import load_checkpoint
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

RES, B = 16, 2


CFG = {"model_size": "tiny", "resolution": RES, "train_batch_size": B, "num_train_epochs": 1,
       "checkpointing_steps": 0, "learning_rate": 1e-4}
PROMPTS = ["a red apple", ""]


@pytest.fixture(scope="module")
def J():
    """The JAX package's side (imported here: the card's machine has no JAX)."""
    jax = pytest.importorskip("jax")
    import dreammat_tpu
    import dreammat_tpu.systems  # noqa: F401  (registry)
    from dreammat_tpu.data.controlnet_dataset import ControlNetDataset as JDataset
    from dreammat_tpu.models.diffusion import convert as jconvert
    from dreammat_tpu.models.diffusion import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, dreammat_tpu=dreammat_tpu,
                                 JDataset=JDataset, jconvert=jconvert, jsched=jsched)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernels have no CPU mode")
    return torch.device("cuda")


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _flat(sd):
    return torch.cat([sd[k].reshape(-1).double() for k in sorted(sd)])


@pytest.fixture(scope="module")
def jtrainer(J):
    return J.dreammat_tpu.find("controlnet-trainer")(dict(CFG))


@pytest.fixture(scope="module")
def jparams(J, jtrainer):
    """The JAX trainer's init_params (after from_unet), the ControlNet as
    flax initialized it before from_unet, and the perturbed ControlNet."""
    import flax.linen as nn

    jax, jnp = J.jax, J.jnp
    init = nn.Module.init
    with pytest.MonkeyPatch.context() as mp:
        # each flax init jitted: the same draws, one compile instead of one per op
        mp.setattr(nn.Module, "init", lambda self, rng, *a: jax.jit(
            lambda r, *x: init(self, r, *x))(rng, *a))
        params = _np(jtrainer.init_params(jax.random.PRNGKey(0)))
        k4 = jax.random.split(jax.random.PRNGKey(0), 4)[3]
        lat = RES // jtrainer.vae_factor
        ctx = jnp.zeros((1, jtrainer.clip_cfg.max_length, jtrainer.unet_cfg.cross_attention_dim))
        raw = _np(jtrainer.controlnet.init(k4, jnp.zeros((1, lat, lat, 4)), jnp.zeros((1,)),
                                           ctx, jnp.zeros((1, 2 * lat, 2 * lat, 22))))
    rng = np.random.RandomState(7)

    def perturb(tree):
        """A copy with every all-zero kernel (the UNet's conv_out, the
        ControlNet's output convs) filled with normal(0, 0.02)."""
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.02, v.shape).astype(np.float32)
                        if k == "kernel" and not np.any(v) else perturb(v))
                    for k, v in tree.items()}
        return np.array(tree)

    frozen = dict(params["frozen"], unet=perturb(params["frozen"]["unet"]))
    return {"init": params, "raw_controlnet": raw,
            "perturbed": {"frozen": frozen, "controlnet": perturb(params["controlnet"])}}


@pytest.fixture(scope="module")
def batch(jtrainer):
    rng = np.random.RandomState(3)
    return {"target": rng.uniform(size=(B, RES, RES, 3)).astype(np.float32),
            "condition": rng.uniform(size=(B, RES, RES, 22)).astype(np.float32),
            "prompts": list(PROMPTS)}


@pytest.fixture(scope="module")
def jax_step(J, jtrainer, jparams, batch):
    """One JAX train step from the perturbed params, its draws, and
    jax.value_and_grad of the same loss (controlnet_trainer.py:165-187)."""
    jax, jnp = J.jax, J.jnp
    tr = jtrainer
    cnet, frozen = jparams["perturbed"]["controlnet"], jparams["perturbed"]["frozen"]
    jb = {"target": jnp.asarray(batch["target"]), "condition": jnp.asarray(batch["condition"]),
          "input_ids": jnp.asarray(tr.tokenizer.batch(batch["prompts"]))}
    rng = jax.random.PRNGKey(1)
    step_fn = tr.make_train_step()
    new_cnet, _, metrics = step_fn(cnet, tr.tx.init(cnet), frozen, jb, rng)

    k_enc, k_t, k_noise = jax.random.split(rng, 3)
    lat = RES // tr.vae_factor
    shape = (B, lat, lat, 4)
    eps = jax.random.normal(k_enc, shape)
    t = jax.random.randint(k_t, (B,), 0, tr.schedule["alphas_cumprod"].shape[0])
    noise = jax.random.normal(k_noise, shape)

    @jax.jit
    def loss_grad(cp):
        latents = tr.vae.apply(frozen["vae"], jb["target"] * 2.0 - 1.0, k_enc,
                               method=tr.vae.encode).astype(jnp.float32)
        noisy = J.jsched.add_noise(tr.schedule, latents, noise, t)
        ctx = tr.clip.apply(frozen["clip"], jb["input_ids"]).astype(jnp.float32)

        def loss_fn(p):
            down, mid = tr.controlnet.apply(p, noisy, t, ctx, jb["condition"], 1.0)
            out = tr.unet.apply(frozen["unet"], noisy, t, ctx,
                                down_block_additional_residuals=down,
                                mid_block_additional_residual=mid)
            return jnp.mean((out - noise) ** 2)

        return jax.value_and_grad(loss_fn)(cp)

    loss, grads = loss_grad(cnet)
    return {"loss": float(metrics["loss"]), "grad_loss": float(loss), "grads": _np(grads),
            "new": _np(new_cnet),
            "draws": {"vae_eps": _nchw(eps), "t": torch.from_numpy(np.array(t)).long(),
                      "noise": _nchw(noise)}}


@pytest.fixture
def ttrainer(jparams):
    tr = ControlNetTrainer(dict(CFG), device="cpu")
    tr.load_state_dicts(convert.controlnet_trainer_state_from_flax(jparams["perturbed"]))
    tr.make_optimizer()
    return tr


def test_from_unet_matches_jax(jparams):
    cfg = ControlNetTrainer(dict(CFG), device="cpu").cnet_cfg
    cnet = ControlNet(cfg)
    cnet.load_state_dict(convert.flax_to_torch_state_dict(jparams["raw_controlnet"], "controlnet"))
    unet = UNet2DCondition(cfg.unet)
    unet.load_state_dict(convert.flax_to_torch_state_dict(jparams["init"]["frozen"]["unet"], "unet"))
    assert controlnet_from_unet(cnet, unet) > 0
    want = convert.flax_to_torch_state_dict(jparams["init"]["controlnet"], "controlnet")
    got = cnet.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the port's own init gives the same structure: seeded blocks equal the
    # UNet's, output convs zero
    tr = ControlNetTrainer(dict(CFG), device="cpu")
    tr.init_params()
    assert torch.equal(tr.controlnet.conv_in.weight, tr.unet.conv_in.weight)
    assert not tr.controlnet.controlnet_mid_block.weight.any()


def _write_dataset(root, res=8, n_views=2, n_envs=2, png=False):
    rng = np.random.RandomState(0)
    os.makedirs(root / "obj1", exist_ok=True)
    np.savez(root / "obj1" / "data.npz",
             colors=rng.rand(n_views, n_envs, res, res, 3).astype(np.float16),
             depths=rng.rand(n_views, res, res, 1).astype(np.float16),
             normals=rng.rand(n_views, res, res, 3).astype(np.float16),
             lightmaps=rng.rand(n_views, n_envs, res, res, 18).astype(np.float16))
    prompts = {"obj1": "a shiny robot"}
    if png:
        from PIL import Image

        d = root / "obj2"
        for sub in ("color", "depth", "normal", "light"):
            os.makedirs(d / sub, exist_ok=True)
        img = lambda c: Image.fromarray((rng.rand(res, res, c) * 255).astype(np.uint8))
        for v in range(n_views):
            img(3).save(d / "depth" / f"{v:03d}.png")
            img(3).save(d / "normal" / f"{v:03d}.png")
            for e in range(1, n_envs + 1):
                img(4).save(d / "color" / f"{v:03d}_color_env{e}.png")
                for tag in ("m0.0r0.0", "m0.0r0.5", "m0.0r1.0", "m1.0r0.0", "m1.0r0.5",
                            "m1.0r1.0"):
                    img(3).save(d / "light" / f"{v:03d}_{tag}_env{e}.png")
        prompts["obj2"] = "a wooden chair"
    pf = root / "prompts.json"
    pf.write_text(json.dumps(prompts))
    return str(pf)


@pytest.mark.parametrize("use_cfg", [False, True])
def test_dataset_matches_jax(J, tmp_path, use_cfg):
    pf = _write_dataset(tmp_path, png=True)
    kw = dict(resolution=8, use_cfg=use_cfg, env_num=2, view_num=2, seed=0)
    jd, td = J.JDataset(str(tmp_path), pf, **kw), ControlNetDataset(str(tmp_path), pf, **kw)
    assert len(td) == len(jd) == 8
    for i in range(3 * len(jd)):
        a, b = jd[i % len(jd)], td[i % len(td)]
        assert a.prompt == b.prompt
        assert np.array_equal(a.condition, b.condition) and np.array_equal(a.target, b.target)
    for a, b in zip(jd.batches(3, epochs=2), td.batches(3, epochs=2)):
        assert a["prompts"] == b["prompts"]
        assert np.array_equal(a["target"], b["target"])
        assert np.array_equal(a["condition"], b["condition"])


def test_ddim_matches_jax(J):
    jsched, jnp = J.jsched, J.jnp
    js = jsched.make_schedule(jsched.SchedulerConfig())
    ts = tsched.make_schedule(tsched.SchedulerConfig(), device="cpu")
    assert np.array_equal(jsched.ddim_timesteps(1000, 20), tsched.ddim_timesteps(1000, 20))
    assert np.array_equal(jsched.ddim_timesteps(1000, 7), tsched.ddim_timesteps(1000, 7))
    rng = np.random.RandomState(4)
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    t, t_prev = np.array([999, 500, 50]), np.array([949, 450, -1])
    want = jsched.ddim_step(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev))
    got = tsched.ddim_step(ts, _nchw(x), _nchw(eps), torch.from_numpy(t), torch.from_numpy(t_prev))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() <= 1e-6
    want = jsched.pred_x0_from_eps(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    got = tsched.pred_x0_from_eps(ts, _nchw(x), _nchw(eps), torch.from_numpy(t))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() <= 1e-6


def test_train_step_matches_jax(ttrainer, jax_step, batch):
    # the gradient of the eps-MSE, before clipping
    loss = ttrainer.compute_loss(batch, jax_step["draws"])
    loss.backward()
    assert abs(loss.item() - jax_step["grad_loss"]) <= 1e-4 * abs(jax_step["grad_loss"])
    got = _flat({n: p.grad for n, p in ttrainer.controlnet.named_parameters()})
    want = _flat(convert.flax_to_torch_state_dict(jax_step["grads"], "controlnet"))
    assert float(got.abs().max()) > 0
    assert float((got - want).norm() / want.norm()) <= 1e-3

    # one whole step: loss, clip by global norm, AdamW
    metrics = ttrainer.train_step(batch, jax_step["draws"])
    assert abs(float(metrics["loss"]) - jax_step["loss"]) <= 1e-4 * abs(jax_step["loss"])
    want = convert.flax_to_torch_state_dict(jax_step["new"], "controlnet")
    for n, p in ttrainer.controlnet.state_dict().items():
        assert float((p - want[n]).abs().max()) <= 1e-5, n


def test_fit_writes_checkpoint_and_export(J, tmp_path):
    from dreammat_tpu_torch import train_controlnet

    pf = _write_dataset(tmp_path / "data", res=RES, n_views=16, n_envs=5)
    cfg = {**CFG, "train_data_dir": str(tmp_path / "data"), "prompt_file_path": pf,
           "controlnet_dir": str(tmp_path / "out"), "sd_cache_dir": None,
           "checkpointing_steps": 2}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    # tensor parallelism needs a process group (tests/test_torch_parallel.py trains under one)
    with pytest.raises(ValueError, match="world size 1"):
        train_controlnet.main(["--config", str(tmp_path / "cfg.json"), "--n-model", "2"],
                              device="cpu")
    out = train_controlnet.main(["--config", str(tmp_path / "cfg.json"), "--max-steps", "3",
                                 "use_cfg=true"], device="cpu")
    tr = out["trainer"]
    assert out["step"] == 3 and tr.cfg.use_cfg
    with open(tmp_path / "out" / "logs" / "metrics.csv") as f:
        assert len(f.read().strip().splitlines()) == 4
    sd, opt, step = load_checkpoint(str(tmp_path / "out" / "checkpoint-2"))
    assert step == 2 and opt["state"]
    sd, _, step = load_checkpoint(str(tmp_path / "out" / "controlnet_final"))
    assert step == 3
    exported = J.jconvert.load_torch_state_dict(out["export"])
    mine = tr.controlnet.state_dict()
    assert sorted(exported) == sorted(mine)
    for k, v in mine.items():
        assert np.array_equal(exported[k], v.numpy()) and torch.equal(sd[k], v), k

    # the port's guidance loads the export strictly through controlnet_path
    import dreammat_tpu_torch

    g = dreammat_tpu_torch.find("stable-diffusion-dreammat-guidance")(
        {"model_size": "tiny", "half_precision_weights": False,
         "controlnet_path": str(tmp_path / "out" / "controlnet")}, device="cpu")
    g.init_params()
    for k, v in g.controlnets[0].state_dict().items():
        assert torch.equal(v, mine[k]), k


def test_validate_runs_ddim(jparams, batch):
    tr = ControlNetTrainer(dict(CFG), device="cpu")
    tr.load_state_dicts(convert.controlnet_trainer_state_from_flax(jparams["perturbed"]))
    img = tr.validate(batch, n_steps=2)
    assert img.shape == (B, RES, RES, 3) and bool(torch.isfinite(img).all())
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


@pytest.mark.cuda
def test_train_step_on_cuda(cuda, monkeypatch):
    """SD2.1 width at resolution 64 (8^2 latents), batch 2, on the card: one
    step launches the kernels as often as the networks hold attentions, the
    ControlNet moves and the frozen UNet does not; the ControlNet's gradient
    through kernels A, C and D agrees with the one through the plain
    attention (cosine >= 0.99: bf16 activations, the kernels round p and ds
    to bf16)."""
    from dreammat_tpu_torch.models.diffusion import layers
    from dreammat_tpu_torch.ops import attention as attn

    tr = ControlNetTrainer({"resolution": 64, "train_batch_size": 2, "learning_rate": 1e-4},
                           device=cuda)
    tr.init_params()
    tr.make_optimizer()
    with torch.no_grad():  # the zero-initialized output convs would stop the gradient
        g = torch.Generator(device=cuda).manual_seed(3)
        for conv in [*tr.controlnet.controlnet_down_blocks, tr.controlnet.controlnet_mid_block]:
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=cuda) * 0.02)
    rng = np.random.RandomState(0)
    batch = {"target": rng.uniform(size=(2, 64, 64, 3)).astype(np.float32),
             "condition": rng.uniform(size=(2, 64, 64, 22)).astype(np.float32),
             "prompts": ["a red apple", ""]}
    draws = {"vae_eps": torch.randn(2, 4, 8, 8, generator=g, device=cuda),
             "t": torch.tensor([10, 700], device=cuda),
             "noise": torch.randn(2, 4, 8, 8, generator=g, device=cuda)}

    def grads(**patch):
        for name, fn in patch.items():
            monkeypatch.setattr(layers, name, fn)
        tr.controlnet.zero_grad(set_to_none=True)
        tr.compute_loss(batch, draws).backward()
        monkeypatch.undo()
        return torch.cat([p.grad.flatten() for p in tr.controlnet.parameters()])

    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv)
    before = [f.launches for f in counters]
    g_kernel = grads()
    assert [f.launches - b for f, b in zip(counters, before)] == [46, 32, 23]
    g_plain = grads(fused_attention=attn.attention_plain)
    cos = torch.nn.functional.cosine_similarity(g_kernel, g_plain, dim=0).item()
    assert cos >= 0.99, cos

    cnet0 = {k: v.clone() for k, v in tr.controlnet.state_dict().items()}
    unet0 = {k: v.clone() for k, v in tr.unet.state_dict().items()}
    m = tr.train_step(batch, draws)
    assert bool(torch.isfinite(m["loss"]))
    assert any(not torch.equal(v, cnet0[k]) for k, v in tr.controlnet.state_dict().items())
    assert all(torch.equal(v, unet0[k]) for k, v in tr.unet.state_dict().items())


def test_safetensors_io_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    from dreammat_tpu_torch.utils import safetensors_io

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "h": torch.randn(2, 2, generator=g).half(), "i": torch.arange(5),
               "m": torch.tensor([True, False]), "e": torch.zeros(0, 4)}
    mine, theirs = str(tmp_path / "mine.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(tensors, mine, metadata={"format": "pt"})
    st.save_file(tensors, theirs)
    for got in (st.load_file(mine), safetensors_io.load_file(theirs),
                safetensors_io.load_file(mine)):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_n_model_needs_a_process_group():
    """``--n-model 2`` in one process raises ``ValueError`` naming the world
    size, before any model is built; without ``--device cpu`` and without a
    GPU the device check raises first."""
    import torch.distributed as tdist

    from dreammat_tpu_torch import train_controlnet

    argv = ["--config", "configs/controlnet_train.yaml", "--n-model", "2"]
    with pytest.raises(ValueError, match="world size 1"):
        train_controlnet.main(argv, device="cpu")
    assert not tdist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_controlnet.main(argv)
