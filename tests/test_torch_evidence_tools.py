"""Port parity: the torch twins of the three main-path evidence tools.

- ``tools/cycles_parity_torch.py``: ``residual_table`` equal to the JAX
  tool's on the same seeded stacks; the PNG cache round trip (the port's
  writer and loader, as ``mc_reference_stack`` makes its reference stack)
  equal to the JAX package's round trip of the same arrays, and within one
  8-bit level of them; ``response_delta`` of the tiny ControlNet, with the
  JAX tool's weights at seeds 0-2 carried across by
  ``flax_to_torch_state_dict`` and its latent sample and context, per seed
  within 1e-3 (relative) of the JAX tool's ``controlnet_delta``.
- ``tools/quantify_fastpath_torch.py``: ``run`` on the level-2 icosphere at
  res 16, 16 samples, oct 8, one environment, given the JAX tool's
  gradient weights W, against the JAX tool's ``run`` (its material's
  shading and gradients jitted: eager they take minutes): every RMSE within
  2e-3 and every gradient cosine within 2e-3 of the JAX row's (the exact
  estimator's grazing shadow rays and nearest-texel lookups round
  differently in the two packages, and 16 samples a pixel make each flip
  count); ``grad_cos_floor`` compares random rotations, which the two
  packages draw differently, so it is only held within [-1, 1].
- ``tools/e2e_evidence_torch.py``: a ``subprocess.TimeoutExpired`` and a
  nonzero return code of the launch (``subprocess.run`` monkeypatched)
  each write a row with ``"failed"`` and make ``main`` return 1; the
  parser reads the phases from a port log and a ``metrics.csv``.
"""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import cycles_parity as jcp  # noqa: E402
import cycles_parity_torch as tcp  # noqa: E402
import e2e_evidence_torch as e2e  # noqa: E402
import quantify_fastpath as jqf  # noqa: E402
import quantify_fastpath_torch as tqf  # noqa: E402
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: E402,F401


def _stacks(seed, shape=(2, 2, 16, 16, 22)):
    rng = np.random.RandomState(seed)
    ref = rng.rand(*shape).astype(np.float32)
    ref[..., 4:8, 4:12, 0] = 0.0  # background: depth 0
    ours = np.clip(ref + 0.05 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return ours, ref


def test_residual_table():
    ours, ref = _stacks(0)
    assert tcp.residual_table(ours, ref) == jcp.residual_table(ours, ref)
    assert tcp.GROUPS == jcp.GROUPS


def test_png_round_trip(tmp_path):
    from dreammat_tpu.data import prerender as jpre
    from dreammat_tpu_torch.data import prerender as tpre

    rng = np.random.RandomState(1)
    Nv, E, H = 2, 2, 16
    lightmaps = rng.rand(Nv, E, H, H, 18).astype(np.float32)
    raw_depth = np.zeros((Nv, H, H), np.float32)
    raw_depth[:, 4:12, 4:12] = 3.0 + rng.rand(Nv, 8, 8)
    normals = rng.rand(Nv, H, H, 3).astype(np.float32)
    tpre.write_reference_png_cache(str(tmp_path / "t"), lightmaps, raw_depth, normals)
    got = tcp.stack_from_png_cache(str(tmp_path / "t"), Nv, E, H)
    jpre.write_reference_png_cache(str(tmp_path / "j"), lightmaps, raw_depth, normals)
    lm, d, n = jpre.load_reference_png_cache(str(tmp_path / "j"), Nv, E, H, H)
    want = np.stack([np.concatenate([d.astype(np.float32), n.astype(np.float32),
                                     lm[:, e].astype(np.float32)], -1) for e in range(E)], 1)
    assert got.shape == (Nv, E, H, H, 22) and np.array_equal(got, want)
    assert np.abs(got[..., 4:] - lightmaps).max() < 1 / 255 + 1e-3
    assert np.abs(got[:, 0, ..., 1:4] - normals).max() < 1 / 255 + 1e-3


def test_controlnet_delta_tiny():
    from dreammat_tpu.models.diffusion.controlnet import ControlNet as JControlNet
    from dreammat_tpu.models.diffusion.controlnet import ControlNetConfig as JConfig
    from dreammat_tpu_torch.models.diffusion import convert
    from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
    from dreammat_tpu_torch.models.diffusion.unet import UNetConfig

    ours, ref = _stacks(2, (1, 2, 16, 16, 22))
    H, seeds = 16, (0, 1, 2)
    want = jcp.controlnet_delta(ours, ref, seeds=seeds)
    assert want["kind"] == "tiny-random"
    jcfg = JConfig.tiny()
    jnet = JControlNet(jcfg)
    lat, ctx_dim = H // 2, jcfg.unet.cross_attention_dim
    cfg = ControlNetConfig(unet=UNetConfig.tiny(), conditioning_embedding_channels=(16, 32))

    def nets():
        for s in seeds:
            params = jnet.init(jax.random.PRNGKey(s), jnp.zeros((1, lat, lat, 4)),
                               jnp.zeros((1,)), jnp.zeros((1, 4, ctx_dim)),
                               jnp.zeros((1, H, H, 22)))
            net = ControlNet(cfg)
            net.load_state_dict(convert.flax_to_torch_state_dict(params, "controlnet"))
            yield s, net.eval()

    sample = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, lat, lat, 4)))
    ctx = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 8, ctx_dim)))
    got = tcp.response_delta(nets(), ours, ref,
                             torch.from_numpy(sample.copy()).permute(0, 3, 1, 2),
                             torch.from_numpy(ctx.copy()))
    for g, w in zip(got, want["per_seed"]):
        assert g["seed"] == w["seed"]
        for k in ("rel_l2_mean", "rel_l2_max"):
            assert abs(g[k] - w[k]) <= 1e-3 * w[k], (k, g, w)


def test_quantify_fastpath_run():
    import dreammat_tpu
    import dreammat_tpu.models  # noqa: F401
    from dreammat_tpu.models.mesh import make_icosphere as jico
    from dreammat_tpu_torch.models.mesh import make_icosphere

    weights = lambda GP: torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(3), (GP, 3))))
    got = tqf.run("sphere", make_icosphere(2, device="cpu"), [8], 1, 16, 16, device="cpu",
                  weights=weights)
    mat_cls = type(dreammat_tpu.find("dreammat-material")(
        {"environment_texture": "/nonexistent", "n_environments": 1, "env_height": 4,
         "env_width": 8}))
    grad = jax.grad
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mat_cls, "shade_raytracing",
                   jax.jit(mat_cls.shade_raytracing, static_argnums=(0, 9)))
        mp.setattr(jax, "grad", lambda f, *a, **k: jax.jit(grad(f, *a, **k)))
        want = jqf.run("sphere", jico(2), [8], 1, 16, 16)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("mesh", "env", "view", "oct_res", "subdiv"):
            assert g[k] == w[k], k
        for k in g:
            if k.startswith("rmse"):
                assert abs(g[k] - float(w[k])) <= 2e-3, (k, g[k], w[k])
            elif k.startswith("grad_cos") and k != "grad_cos_floor":
                assert abs(g[k] - float(w[k])) <= 2e-3, (k, g[k], w[k])
        assert -1.0 <= g["grad_cos_floor"] <= 1.0


# ---------------------------------------------------------------------------
# e2e_evidence_torch
# ---------------------------------------------------------------------------

@pytest.fixture
def e2e_args(tmp_path):
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    return ["--device", "cpu", "--mesh", str(tmp_path / "m.obj"), "--out",
            str(tmp_path / "row.json"), "--exp-root-dir", str(tmp_path / "runs"),
            "--timeout", "5"]


@pytest.mark.parametrize("outcome", ["timeout", "rc"])
def test_e2e_failure_writes_a_row(outcome, e2e_args, tmp_path, monkeypatch):
    def fake_run(cmd, **kw):
        assert cmd[1] == "launch_torch.py" and "trainer.log_every_n_steps=1" in cmd
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"], output=b"prerender: G-buffers "
                                            b"for 8 views in 1.50s\n", stderr=None)
        return subprocess.CompletedProcess(cmd, 3, stdout="", stderr="Traceback: boom\n")

    monkeypatch.setattr(e2e.subprocess, "run", fake_run)
    assert e2e.main(e2e_args) == 1
    row = json.loads((tmp_path / "row.json").read_text())
    if outcome == "timeout":
        assert row["failed"] == "timeout" and row["timeout_s"] == 5.0
        assert row["phases"]["prerender_gbuffers_s"] == 1.5
    else:
        assert row["failed"] == 3 and "boom" in row["log_tail"]
    assert row["phases"]["static_maps_s"] is None and row["render_fingerprint"] == {}


def test_e2e_parses_a_port_log(tmp_path):
    trial = tmp_path / "trial"
    (trial / "logs").mkdir(parents=True)
    with open(trial / "logs" / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["step", "loss", "seconds"])
        w.writeheader()
        for i, s in enumerate([2.5, 0.2, 0.3, 0.25]):
            w.writerow({"step": i + 1, "loss": 1.0, "seconds": s})
    log = ("[dreammat-torch] INFO prerender: G-buffers for 8 views in 0.41s\n"
           "[dreammat-torch] INFO prerender: mesh-wide bakes in 0.73s\n"
           "[dreammat-torch] INFO prerender: probes+tables for 8 views in 1.27s\n"
           "[dreammat-torch] INFO step 4 loss=1.0000 sds=1 (tables, 0.250 s/step)\n"
           "[dreammat-torch] INFO test render: 3.1s\n"
           "[dreammat-torch] INFO export: 9.4s\n"
           "[dreammat-torch] INFO setup, training, test renders and export: 40.2s\n")
    ph = e2e.parse_phases(log, str(trial))
    assert ph["prerender_gbuffers_s"] == 0.41 and ph["prerender_bakes_s"] == 0.73
    assert ph["prerender_probes_tables_s"] == 1.27 and ph["static_maps_s"] is None
    assert ph["first_step_s"] == 2.5 and ph["steps_logged"] == 4
    assert ph["warm_steps_per_sec"] == pytest.approx(3 / 0.75)
    assert ph["warm_step_s_median"] == 0.25
    assert ph["test_render_s"] == 3.1 and ph["export_s"] == 9.4
    assert ph["setup_train_test_export_s"] == 40.2
