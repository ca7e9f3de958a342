"""Port parity: Control4D (the GAN volume renderer, the CO3D datamodule and
the two-optimizer system) against the JAX package.

The same numpy-seeded inputs, and the JAX package's random draws by name,
go through both packages on the CPU at tiny size; the GAN networks' flax
trees are made from numpy and carried across by
``gan_state_dict_from_flax``:

- the CO3D loader on a one-sequence layout the test writes (the JAX tests'
  ``_write_co3d``): each frame's pose, intrinsics, crop, image, mask and
  depth, the batches with their random camera, and both eval paths, to
  1e-5 absolute; ``similarity_from_cameras``, the box crop and the padded
  resize on their own, to 1e-6 (float32 numpy both sides);
- the GAN renderer at generator levels 0, 1 and 2 in training (the level,
  the probe's offsets and the z draw injected): every output, the KL and
  the field's gradient to relative 1e-4, the gradients of the generator
  and both encoders to 1e-4 of each network's largest; its evaluation
  render and ``render_image``;
- the hinge losses and the discriminator's gradient, to relative 1e-5;
- one Control4D ``fit`` step (the generator side, then the discriminator
  on the same fake) against the jitted JAX steps: the generator level, the
  losses to relative 1e-4, the moves of the field, the generator side and
  the discriminator to relative L2 0.05, each tensor whose gradient is
  above 1e-6 of its network's largest (below, the first Adam step is an
  lr-sized sign of rounding).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.data  # noqa: F401
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.data  # noqa: F401
import dreammat_tpu_torch.models  # noqa: F401
import dreammat_tpu_torch.systems  # noqa: F401
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.models.diffusion.convert import (
    gan_state_dict_from_flax, geometry_params_from_numpy, vgg16_state_dict_from_flax,
    volume_scene_from_numpy,
)
from dreammat_tpu_torch.utils import gan as tgan
from dreammat_tpu_torch.utils.config import load_config as tload

from test_torch_dreammat_step import _np, _rel
from test_torch_in2n import numpy_vgg16
from test_torch_volume import (
    SEED, GivenDraws, _close, _render_draws,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401
from test_torch_zero123 import numpy_params
from tests.test_co3d import _write_co3d
from tests.test_in2n import _make_scene

RTOL = 1e-4
GAN_KINDS = ("generator", "local_encoder", "global_encoder", "discriminator")
GAN_CFG = {"ch": 16, "local_ch": 8, "z_channels": 4, "global_dim": 16, "disc_ndf": 16,
           "disc_layers": 2, "base_renderer_type": "nerf-volume-renderer",
           "base_renderer": {"radius": 1.0, "num_samples_per_ray": 16, "estimator": "occgrid",
                             "grid_resolution": 8}}


# -- CO3D ------------------------------------------------------------------------------------
def test_co3d_helpers_match_jax(tmp_path):
    from dreammat_tpu.data import co3d as jco3d
    from dreammat_tpu_torch.data import co3d as tco3d

    d = np.random.RandomState(0).rand(12, 10).astype(np.float16) * 5
    from PIL import Image

    p = str(tmp_path / "d.png")
    Image.fromarray(np.frombuffer(d.tobytes(), np.uint16).reshape(12, 10)).save(p)
    assert np.array_equal(tco3d.load_16bit_png_depth(p), d.astype(np.float32))
    assert np.array_equal(tco3d.load_depth(p, 2.0), jco3d.load_depth(p, 2.0))

    rng = np.random.RandomState(1)
    c2w = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    for i in range(7):
        q = rng.normal(size=(3, 3))
        c2w[i, :3, :3] = np.linalg.qr(q)[0] * np.sign(np.linalg.det(np.linalg.qr(q)[0]))
        c2w[i, :3, 3] = rng.normal(size=3) * 4
    (jt, js), (tt, ts) = (jco3d.similarity_from_cameras(c2w, 0.7),
                          tco3d.similarity_from_cameras(c2w, 0.7))
    assert np.abs(tt - jt).max() <= 1e-6 and abs(ts - js) <= 1e-6 * js
    assert abs(np.median(np.linalg.norm((tt @ c2w)[:, :3, 3], axis=-1)) * ts - 0.7) < 1e-6

    mask = np.zeros((30, 20), np.float32)
    mask[5:17, 3:11] = rng.uniform(0.3, 1.0, (12, 8))
    img = rng.uniform(size=(30, 20, 3)).astype(np.float32)
    for thr in (0.4, 0.95):
        bb_t = tco3d.clamp_bbox(np.asarray(tco3d.get_bbox_from_mask(mask, thr)), 0.3)
        bb_j = jco3d.clamp_bbox(np.asarray(jco3d.get_bbox_from_mask(mask, thr)), 0.3)
        assert np.array_equal(bb_t, bb_j)
        assert np.array_equal(tco3d.crop_box(img, bb_t), jco3d.crop_box(img, bb_j))
    (ti, tsc), (ji, jsc) = tco3d.resize_with_pad(img, 16, 16), jco3d.resize_with_pad(img, 16, 16)
    assert tsc == jsc and np.abs(ti - ji).max() <= 1e-6 and ti[:, 11:].max() == 0.0


@pytest.mark.parametrize("render_path", ["circle", "frames"])
def test_co3d_datamodule_matches_jax(tmp_path, render_path):
    seq = _write_co3d(str(tmp_path))
    cfg = {"root_dir": seq, "height": 24, "width": 24, "box_crop": True,
           "use_random_camera": True, "render_path": render_path,
           "random_camera": {"height": 24, "width": 24, "eval_height": 16, "eval_width": 16,
                             "n_test_views": 2}}
    jdm = dreammat_tpu.find("co3d-datamodule")(cfg, None, None)
    tdm = dreammat_tpu_torch.find("co3d-datamodule")(cfg, None, None, device="cpu")
    jdm.setup(), tdm.setup()
    assert tdm.n_frames == jdm.n_frames == 4
    for jf, tf in zip(jdm.frames, tdm.frames):
        for key in ("c2w", "fx", "fy", "cx", "cy", "rgb", "depth", "mask"):
            assert np.abs(np.asarray(tf[key], np.float64) - np.asarray(jf[key])).max() <= 1e-5, key
    assert 0 < tdm.frames[0]["mask"].mean() < 1 and tdm.frames[0]["depth"].max() > 0
    for step in range(2):
        jb, tb = jdm.collate(step), tdm.collate(step)
        assert tb["index"] == jb["index"]
        for key in ("rays_o", "rays_d", "light_positions", "rgb", "gt_rgb", "mask", "ref_depth",
                    "camera_distances"):
            _close(tb[key], jb[key], rtol=1e-5, what=(step, key))
        for key in ("rays_o", "rays_d", "light_positions", "c2w"):
            _close(tb["random_camera"][key], jb["random_camera"][key], rtol=1e-5,
                   what=(step, "random_camera", key))
    jv, tv = jdm.eval_rays(1), tdm.eval_rays(1)
    assert tv["rays_o"].shape == ((16, 16, 3) if render_path == "circle" else (24, 24, 3))
    for key in ("rays_o", "rays_d", "light_position"):
        _close(tv[key], np.asarray(jv[key]).reshape(tv[key].shape), rtol=1e-5, what=key)


# -- the GAN renderer --------------------------------------------------------------------------
def numpy_gan_params(rend, H, W, seed=3):
    """The JAX renderer's four networks' trees from numpy (``numpy_params``)."""
    cfg = rend.cfg
    hl, wl = H // rend.scale, W // rend.scale
    img = jnp.zeros((1, H, W, 3))
    return {
        "generator": numpy_params(rend.generator, jnp.zeros((1, hl, wl, 3 + cfg.z_channels)),
                                  jnp.zeros((1, cfg.global_dim)), seed=seed, noise=0.05),
        "local_encoder": numpy_params(rend.local_encoder, img, seed=seed + 1, noise=0.05),
        "global_encoder": numpy_params(rend.global_encoder, img, seed=seed + 2, noise=0.05),
        "discriminator": numpy_params(rend.discriminator, img, seed=seed + 3, noise=0.05),
    }


def gan_state(jgan, cfg) -> dict:
    """The JAX networks' trees (numpy) -> a ``GANNetworks`` state dict."""
    levels = {"generator": len(cfg["ch_mult"]) if "ch_mult" in cfg else 3,
              "local_encoder": len(cfg["ch_mult"]) if "ch_mult" in cfg else 3,
              "global_encoder": 4, "discriminator": cfg["disc_layers"]}
    return {f"{kind}.{k}": v for kind in GAN_KINDS
            for k, v in gan_state_dict_from_flax(_np(jgan[kind]), kind, levels[kind]).items()}


@pytest.fixture(scope="module")
def rig():
    from test_torch_volume import _geometries

    jg, tg, jp, tf = _geometries("finite_difference", n_feature_dims=11)
    jm = dreammat_tpu.find("hybrid-rgb-latent-material")({"n_output_dims": 11})
    tm = dreammat_tpu_torch.find("hybrid-rgb-latent-material")({"n_output_dims": 11},
                                                               device="cpu")
    bcfg = {"n_output_dims": 11}
    jb = dreammat_tpu.find("solid-color-background")(bcfg)
    tb = dreammat_tpu_torch.find("solid-color-background")(bcfg, device="cpu")
    bfield = tb.init(torch.Generator().manual_seed(0))
    jr = dreammat_tpu.find("gan-volume-renderer")(GAN_CFG, jg, jm, jb)
    tr = dreammat_tpu_torch.find("gan-volume-renderer")(GAN_CFG, tg, tm, tb, device="cpu")
    k = jax.random.PRNGKey(11)
    state = jax.jit(jr.update_occ)(jp, jr.init_state(k), k)
    H = W = 24
    jgan = numpy_gan_params(jr, H, W)
    nets = tr.init_networks(torch.Generator().manual_seed(0))
    nets.load_state_dict(gan_state(jgan, GAN_CFG), strict=True)
    rng = np.random.RandomState(4)
    ys, xs = np.meshgrid(np.linspace(-0.5, 0.5, H), np.linspace(-0.5, 0.5, W), indexing="ij")
    ro = np.stack([xs, ys, np.full_like(xs, 2.0)], -1).reshape(-1, 3).astype(np.float32)
    rd = np.broadcast_to(np.float32([0.0, 0.0, -1.0]), ro.shape) + rng.normal(
        0, 0.05, ro.shape).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    light = np.broadcast_to(np.float32([2.0, 2.0, 2.0]), ro.shape).copy()
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    return dict(jr=jr, tr=tr, jp=jp, tf=tf, bp=jb.init(k), bfield=bfield, state=state,
                occ=torch.from_numpy(np.array(state["occ"])), jgan=jgan, nets=nets, H=H, W=W,
                ro=ro, rd=rd, light=light, gt=gt)


def gan_draws(k, jr, H, W, N_probe, level_two_shape=None):
    """The draws of the JAX GAN render's key, by the port's names."""
    k_base, k_z, k_int = jax.random.split(k, 3)
    s = jr.scale
    Hl, Wl = len(range(s // 2, H, s)), len(range(s // 2, W, s))
    S, Sc = jr.base.cfg.num_samples_per_ray, jr.base.cfg.num_samples_per_ray_importance
    d = {"base/" + n: v for n, v in _render_draws(k_base, Hl * Wl, S, Sc).items()}
    d.update({"probe/" + n: v for n, v in _render_draws(k_int, N_probe, S, Sc).items()})
    d["gan_z"] = jax.random.normal(k_z, level_two_shape or (1, Hl, Wl, jr.cfg.z_channels))
    return d


GAN_KEYS = ("comp_gan_rgb", "comp_rgb", "comp_lr_rgb", "opacity", "comp_int_rgb",
            "comp_gt_rgb")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gan_renderer_level_matches_jax(rig, level):
    r = rig
    jr, tr, H, W = r["jr"], r["tr"], r["H"], r["W"]
    k = jax.random.PRNGKey(20 + level)
    offs = (3, 5)
    cs = np.random.RandomState(5).normal(size=(3, H * W, 3)).astype(np.float32)

    def jloss(gen, geo):
        out = jr.render_rays(geo, r["bp"], r["state"], r["ro"], r["rd"], r["light"], k,
                             is_train=True, gan_params={**r["jgan"], **gen}, gt_rgb=r["gt"],
                             generator_level=level, int_offsets=(jnp.int32(offs[0]),
                                                                 jnp.int32(offs[1])),
                             height=H, width=W)
        loss = (jnp.sum(out["comp_gan_rgb"] * cs[0]) + jnp.sum(out["comp_rgb"] * cs[1])
                + jnp.sum(out["comp_int_rgb"] * cs[2][:out["comp_int_rgb"].shape[0]])
                + out["kl"])
        return loss, {key: out[key] for key in GAN_KEYS + ("kl",)}

    gen = {kind: r["jgan"][kind] for kind in GAN_KINDS[:3]}
    (jl, jout), (jg_gen, jg_geo) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(gen, r["jp"])
    nets, tf = r["nets"], r["tf"]
    for p in list(nets.parameters()) + list(tf.parameters()):
        p.grad = None
    n_probe = jout["comp_int_rgb"].shape[0]
    draws = GivenDraws(gan_draws(k, jr, H, W, n_probe))
    out = tr.render_rays(tf, r["bfield"], r["occ"], torch.from_numpy(r["ro"]),
                         torch.from_numpy(r["rd"]), torch.from_numpy(r["light"]), draws,
                         is_train=True, gan_nets=nets, gt_rgb=torch.from_numpy(r["gt"]),
                         generator_level=level, int_offsets=offs, height=H, width=W)
    loss = (torch.sum(out["comp_gan_rgb"] * torch.from_numpy(cs[0]))
            + torch.sum(out["comp_rgb"] * torch.from_numpy(cs[1]))
            + torch.sum(out["comp_int_rgb"] * torch.from_numpy(cs[2][:n_probe])) + out["kl"])
    loss.backward()
    assert out["generator_level"] == level and n_probe == 9
    for key in GAN_KEYS + ("kl",):
        _close(out[key].detach(), jout[key], rtol=RTOL, what=key)
    assert abs(loss.item() - float(jl)) <= RTOL * abs(float(jl))
    want = gan_state({**jg_gen, "discriminator": r["jgan"]["discriminator"]}, GAN_CFG)
    for kind in GAN_KINDS[:3]:
        # to 1e-4 of the network's largest gradient: a bias that a GroupNorm
        # of one channel per group removes has a rounding-level gradient
        scale = max(float(np.abs(v.numpy()).max()) for k, v in want.items()
                    if k.startswith(kind + "."))
        for name, p in getattr(nets, kind).named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            assert np.abs(g.numpy() - want[f"{kind}.{name}"].numpy()).max() <= RTOL * scale, \
                (kind, name)
    assert all(p.grad is None for p in nets.discriminator.parameters())
    # the local encoder is trained at level 2 only
    assert (nets.local_encoder.conv_in.weight.grad is not None) == (level == 2)
    ref = geometry_params_from_numpy(_np(jg_geo))
    for name, p in tf.named_parameters():
        assert _rel(p.grad.numpy(), ref[name].numpy()) <= RTOL, name


def test_gan_renderer_eval_and_render_image_match_jax(rig):
    """Evaluation: the latent's mean, the image's own global code; the
    edit's render (``Control4D.edit_render``) and ``render_image``."""
    r = rig
    jr, tr, H, W = r["jr"], r["tr"], r["H"], r["W"]
    ro, rd = r["ro"].reshape(H, W, 3), r["rd"].reshape(H, W, 3)
    lp = np.float32([1.0, 2.0, 1.5])

    def jeval(gp, geo):
        key = jax.random.PRNGKey(0)
        out = jr.render_rays(geo, r["bp"], r["state"], r["ro"], r["rd"], r["light"], key,
                             is_train=False, gan_params=gp, height=H, width=W)
        return out["comp_gan_rgb"], jr.render_image(geo, r["bp"], r["state"], ro, rd, lp, key,
                                                    gan_params=gp)

    jout, jimg = jax.jit(jeval)(r["jgan"], r["jp"])
    with torch.no_grad():
        out = tr.render_rays(r["tf"], r["bfield"], r["occ"], torch.from_numpy(r["ro"]),
                             torch.from_numpy(r["rd"]), torch.from_numpy(r["light"]), None,
                             gan_nets=r["nets"], height=H, width=W)
    _close(out["comp_gan_rgb"], jout, rtol=RTOL, what="eval comp_gan_rgb")
    tr.base.cfg.eval_chunk_rays = 10  # the base pass's 36 rays in four chunks
    timg = tr.render_image(r["tf"], r["bfield"], r["occ"], torch.from_numpy(ro),
                           torch.from_numpy(rd), torch.from_numpy(lp), None, gan_nets=r["nets"])
    assert sorted(timg) == sorted(jimg) == ["comp_gan_rgb", "comp_rgb", "opacity"]
    for key in jimg:
        _close(timg[key], jimg[key], rtol=RTOL, what=key)


def test_hinge_losses_match_jax(rig):
    from dreammat_tpu.utils import gan as jgan_lib

    r = rig
    jr, H, W = r["jr"], r["H"], r["W"]
    rng = np.random.RandomState(6)
    real = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    fake = rng.uniform(size=(1, H, W, 3)).astype(np.float32)

    def jlosses(dp):
        return (jgan_lib.generator_loss(jr.disc_apply, dp, fake),
                jgan_lib.discriminator_loss(jr.disc_apply, dp, real, fake))

    jlg, jld = jax.jit(jlosses)(r["jgan"]["discriminator"])
    jgrad = jax.jit(jax.grad(lambda dp: jlosses(dp)[1]))(r["jgan"]["discriminator"])
    disc = r["nets"].discriminator
    disc.zero_grad(set_to_none=True)
    t = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)
    tlg = tgan.generator_loss(disc, t(fake))
    tld = tgan.discriminator_loss(disc, t(real), t(fake))
    tld.backward()
    assert abs(tlg.item() - float(jlg)) <= 1e-5 * abs(float(jlg))
    assert abs(tld.item() - float(jld)) <= 1e-5 * abs(float(jld)) and float(jld) > 0
    want = gan_state_dict_from_flax(_np(jgrad), "discriminator", GAN_CFG["disc_layers"])
    for name, p in disc.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) <= 1e-5, name
    disc.zero_grad(set_to_none=True)


# -- the system ------------------------------------------------------------------------------
C4D_OVERRIDES = [
    "system_type=control4d-multiview-system",
    "data_type=multiview-camera-datamodule",
    "system.prompt_processor.prompt=make it a painting",
    "system.geometry.n_feature_dims=11",
    "system.material_type=hybrid-rgb-latent-material",
    "system.material!={n_output_dims: 11}",
    "system.background_type=solid-color-background",
    "system.background!={n_output_dims: 11}",
    "system.renderer_type=gan-volume-renderer",
    "system.renderer!={ch: 16, local_ch: 8, z_channels: 4, global_dim: 16, disc_ndf: 16, "
    "disc_layers: 2, base_renderer_type: nerf-volume-renderer, base_renderer: {radius: 1.0, "
    "num_samples_per_ray: 16, estimator: occgrid, grid_resolution: 8}}",
    "system.per_editing_step=1", "system.start_editing_step=0",
    "system.loss!={lambda_l1: 10.0, lambda_p: 10.0, lambda_G: 1.0, lambda_kl: 0.01, "
    "lambda_D: 1.0, lambda_orient: 0.0, lambda_sparsity: 0.5, lambda_opaque: 0.1}",
]


def _csv_column(path, column):
    with open(path) as f:
        return [float(r[column]) for r in csv.DictReader(f)]


def test_control4d_step_matches_jax(tmp_path_factory, tmp_path):
    """Step 0 of ``fit`` (no edit before step 1): the generator side's step
    and the discriminator's on its fake, from the same scene and networks."""
    from dreammat_tpu.models.volume_renderer import NeRFVolumeRenderer as JNeRF
    from dreammat_tpu.utils import perceptual as jperceptual

    scene = _make_scene(str(tmp_path_factory.mktemp("c4d")), hw=48)
    over = C4D_OVERRIDES + [f"data!={{dataroot: {scene}, train_downsample_resolution: 2}}"]
    jcfg = jload("configs/dreamfusion_tiny.yaml", over)
    tcfg = tload("configs/dreamfusion_tiny.yaml", over)
    vgg = numpy_vgg16()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jperceptual, "init_vgg16", lambda *a, **k: vgg)
        jsys = dreammat_tpu.find("control4d-multiview-system")(jcfg.system)
    jdm = dreammat_tpu.find(jcfg.data_type)(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    tsys = dreammat_tpu_torch.find("control4d-multiview-system")(tcfg.system, device="cpu")
    tdm = dreammat_tpu_torch.find(tcfg.data_type)(tcfg.data, tsys.renderer, tsys.material,
                                                  device="cpu")
    tdm.setup()
    tsys.vgg.load_state_dict(vgg16_state_dict_from_flax(vgg), strict=True)
    # no edit at step 0: neither package needs its guidance or prompts
    for s in (jsys, tsys):
        s.guidance, s.prompt_processor, s.prompt_utils = "unused", "unused", "unused"
    k_init = jax.random.split(jax.random.PRNGKey(SEED), 3)[0]
    jitted = jax.jit(JNeRF.update_occ, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JNeRF, "update_occ", lambda self, *a: jitted(self, *a))
        state0 = _np(jsys.init_state(k_init))
    H = W = 24
    jgan0 = numpy_gan_params(jsys.renderer, H, W, seed=8)
    jsys.renderer.init_params = lambda rng, h, w: jax.tree_util.tree_map(jnp.asarray, jgan0)
    jstate = jsys.fit(jdm, max_steps=1, state=jax.tree_util.tree_map(jnp.asarray, state0),
                      seed=SEED, trial_dir=str(tmp_path / "jax"), val_check_interval=0,
                      checkpoint_every=0, log_every=1)

    tsys.init_state(SEED)
    rcfg = dict(tcfg.system["renderer"])
    sd = volume_scene_from_numpy(state0["geo"], state0["bg"], state0["render"]["occ"])
    sd.update({"gan." + k: v for k, v in gan_state(jgan0, rcfg).items()})
    tsys.field.load_state_dict(sd, strict=True)
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    _, k = jax.random.split(rng)
    _, k_lvl, k_step = jax.random.split(k, 3)
    G = jsys.renderer.base.cfg.grid_resolution
    d = gan_draws(k_step, jsys.renderer, H, W, 9)
    d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k, 0x0CC), (G ** 3, 3))
    d["generator_level"] = jax.random.randint(k_lvl, (), 0, 3)
    tsys.fit(tdm, max_steps=1, seed=SEED, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=GivenDraws([d]))
    assert tsys.levels == [int(d["generator_level"])] and not tsys.edit_frames
    for col in ("loss", "loss_l1", "loss_p", "loss_G", "loss_D"):
        jl = _csv_column(os.path.join(tmp_path, "jax", "logs", "metrics.csv"), col)
        tl = _csv_column(os.path.join(tmp_path, "torch", "logs", "metrics.csv"), col)
        assert np.allclose(tl, jl, rtol=1e-4, atol=0), (col, tl, jl)
    want = volume_scene_from_numpy(_np(jstate["geo"]), _np(jstate["bg"]),
                                   jstate["render"]["occ"])
    want.update({"gan." + k: v for k, v in gan_state(_np(jstate["gan"]), rcfg).items()})
    # a tensor whose gradient is below 1e-6 of its network's largest is
    # rounding (a conv bias that a GroupNorm of one channel per group takes
    # out again): the first Adam step, eps 1e-15, turns it into lr with a
    # random sign in either package, so there only the size is held
    net = lambda name: ".".join(name.split(".")[:2 if name.startswith("gan.") else 1])
    scale = {}
    for name, p in tsys.field.named_parameters():
        scale[net(name)] = max(scale.get(net(name), 0.0), float(p.grad.abs().max()))
    lr = tcfg.system["optimizer"]["args"]["lr"]
    compared = rounding = 0
    for name, p in tsys.field.named_parameters():
        moved_t, moved_j = (p.detach() - sd[name]).numpy(), (want[name] - sd[name]).numpy()
        if np.abs(moved_j).max() == 0:  # a network the level left unused
            assert np.abs(moved_t).max() == 0, name
        elif float(p.grad.abs().max()) < 1e-6 * scale[net(name)]:
            rounding += 1
            assert np.abs(moved_t).max() <= lr * (1 + 1e-4), name
        else:
            compared += 1
            assert _rel(moved_t, moved_j) < 0.05, name
    assert compared > len(sd) // 2 and rounding < 8

    # the checkpoint carries the networks and both optimizers' states
    from dreammat_tpu_torch.utils.ckpt import load_checkpoint

    path = tsys.save_checkpoint(str(tmp_path / "torch"), 1)
    fresh = dreammat_tpu_torch.find("control4d-multiview-system")(tcfg.system, device="cpu")
    fresh.load_state(*load_checkpoint(path))
    assert fresh.global_step == 1
    for name, v in tsys.field.state_dict().items():
        assert torch.equal(fresh.field.state_dict()[name], v), name
    for opt, back in ((tsys.optimizer, fresh.optimizer), (tsys.optimizer_d, fresh.optimizer_d)):
        a, b = opt.state_dict()["state"], back.state_dict()["state"]
        assert sorted(a) == sorted(b) and len(a) > 0
        assert all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)


def test_chip_smoke_edit_path_on_cpu(tmp_path):
    """Main path 11's CPU form: the capture, both runs through
    ``launch_torch.main`` and the SDS phase at tiny size."""
    import chip_smoke

    res = chip_smoke.drive_edit(str(tmp_path / "work"), device="cpu", size="tiny")
    runs = res["runs"]
    assert list(runs) == list(chip_smoke.EDIT_RUNS)
    assert [r["system"] for r in runs.values()] == ["InstructNeRF2NeRF", "Control4D"]
    assert runs["control4d"]["renderer"] == "GANVolumeRenderer"
    assert runs["instructnerf2nerf"]["edits"] == 2 and runs["control4d"]["edits"] == 6
    assert set(runs["control4d"]["moved"]) >= {"geo", "gan.generator", "gan.discriminator"}
    assert len(res["ip2p_sds"]["losses"]) == 3 and res["ip2p_sds"]["image_moved"] > 0
    assert 0.05 < res["capture"]["hit_share"] < 0.9


@pytest.mark.parametrize("entry", ["in2n_system", "control4d_system", "multiview", "co3d",
                                   "ip2p_guidance", "gan_renderer", "vgg16"])
def test_edit_entry_points_need_cuda_unless_cpu_is_asked_for(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    from dreammat_tpu_torch.utils.perceptual import init_vgg16

    find = dreammat_tpu_torch.find
    cfg = tload("configs/dreamfusion_tiny.yaml", C4D_OVERRIDES)
    c4d = find("control4d-multiview-system")(cfg.system, device="cpu")
    build = {
        "in2n_system": lambda **kw: find("instructnerf2nerf-system")(
            tload("configs/dreamfusion_tiny.yaml", ["system.prompt_processor.prompt=x"]).system,
            **kw),
        "control4d_system": lambda **kw: find("control4d-multiview-system")(cfg.system, **kw),
        "multiview": lambda **kw: find("multiview-camera-datamodule")({}, None, None, **kw),
        "co3d": lambda **kw: find("co3d-datamodule")({}, None, None, **kw),
        "ip2p_guidance": lambda **kw: find("stable-diffusion-instructpix2pix-guidance")(
            {"model_size": "tiny"}, **kw),
        "gan_renderer": lambda **kw: find("gan-volume-renderer")(
            cfg.system["renderer"], c4d.geometry, c4d.material, c4d.background, **kw),
        "vgg16": lambda **kw: init_vgg16(torch.Generator(), None, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    out = build(device="cpu")
    dev = out.device if hasattr(out, "device") else next(out.parameters()).device
    assert dev.type == "cpu"
