"""Port parity: optimizers, schedulers and the training loggers.

Each optimizer of ``parse_optimizer`` (Adan with and without weight decay
and with the default betas, SGD with and without momentum, Adam, AdamW) is
built in both packages from the same config, fed the same fixed gradients
for five steps from the same parameters, and must give the same parameters
after every step to 1e-6 (absolute, on values of order 1). Each scheduler
of ``parse_scheduler`` gives the JAX schedule's learning rate at steps
0..5 to 1e-6 of the base rate. The loggers (the copies of
``utils/tboard.py`` and ``utils/loggers.py``) write the same bytes as the
JAX package's, and the port's ``fit`` writes the TSV events, a TensorBoard
event file and the progress file beside ``metrics.csv``, as the JAX
system's does.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreammat_tpu_torch
from dreammat_tpu.systems import optimizers as jopt
from dreammat_tpu.utils import loggers as jlog
from dreammat_tpu.utils import tboard as jtb
from dreammat_tpu_torch.systems import optimizers as topt
from dreammat_tpu_torch.utils import loggers as tlog
from dreammat_tpu_torch.utils import tboard as ttb
from dreammat_tpu_torch.utils.config import load_config
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

OPTIMIZERS = {
    "adan": {"name": "Adan", "args": {"lr": 0.05, "betas": [0.98, 0.92], "eps": 1e-8}},
    "adan_wd": {"name": "Adan", "args": {"lr": 0.02, "betas": [0.9, 0.8], "eps": 1e-6,
                                         "weight_decay": 0.1}},
    "adan_default_betas": {"name": "Adan", "args": {"lr": 0.01}},
    "sgd": {"name": "SGD", "args": {"lr": 0.1}},
    "sgd_momentum": {"name": "SGD", "args": {"lr": 0.1, "momentum": 0.9}},
    "adam": {"name": "Adam", "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15}},
    "adamw": {"name": "AdamW", "args": {"lr": 0.01, "weight_decay": 0.05}},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    cfg = OPTIMIZERS[name]
    rng = np.random.RandomState(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    tx = jopt.parse_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = topt.parse_optimizer(cfg, [tp["a"], tp["b"]])
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
        for k in tp:
            err = np.abs(tp[k].detach().numpy() - np.asarray(jp[k])).max()
            assert err <= 1e-6, (k, err)
    moved = max(np.abs(tp[k].detach().numpy() - p0[k]).max() for k in tp)
    assert moved > 1e-3


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.parse_optimizer({"name": "Lion"}, [torch.nn.Parameter(torch.zeros(1))])


SCHEDULERS = {
    "exponential": {"name": "ExponentialLR", "args": {"gamma": 0.9}},
    "exponential_default": {"name": "ExponentialLR"},
    "linear": {"name": "LinearLR", "args": {"total_iters": 4}},
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    cfg, base = SCHEDULERS[name], 0.05
    sched_j = jopt.parse_scheduler(cfg, base)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=base)
    sched_t = topt.parse_scheduler(cfg, opt)
    for step in range(6):
        assert abs(opt.param_groups[0]["lr"] - float(sched_j(step))) <= 1e-6 * base, step
        opt.step()
        sched_t.step()
    assert topt.parse_scheduler(None, opt) is None


def test_tensorboard_records_match_jax():
    scalars = {"loss": 1.25, "loss_sds": -3.5e-4, "lr": 0.01}
    for args in ((1.7e9, None, None, "brain.Event:2"), (1.7e9 + 1, 12, scalars, None)):
        assert ttb.tfrecord(ttb.encode_event(*args)) == jtb.tfrecord(jtb.encode_event(*args))
    assert ttb.masked_crc32c(b"dreammat") == jtb.masked_crc32c(b"dreammat")


def test_csv_and_progress_files_match_jax(tmp_path):
    for mod, sub in ((tlog, "t"), (jlog, "j")):
        csv_log = mod.CSVLogger(str(tmp_path / sub))
        for step in (1, 2):
            csv_log.log({"loss": 0.5 / step, "grad_norm": step}, step)
        mod.ProgressWriter(str(tmp_path / sub / "progress")).update(3, 8)
    for name in ("metrics.csv", "progress"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_fit_writes_the_loggers_files(tmp_path):
    cfg = load_config("configs/dreammat_tiny.yaml", [
        "system.prompt_processor.prompt=a red apple",
        "system.geometry.shape_init=procedural:sphere", "system.geometry.shape_init_params=1",
        "system.material.use_prefiltered=true", "data.fix_view_num=1",
        "system.optimizer.name=Adan"])
    find = dreammat_tpu_torch.find
    system = find("dreammat-system")(cfg.system, device="cpu")
    dm = find("random-camera-datamodule")(cfg.data, system.renderer, system.material,
                                          device="cpu")
    dm.setup()
    system.fit(dm, max_steps=2, trial_dir=str(tmp_path), log_every=1, val_check_interval=0,
               checkpoint_every=0)
    assert isinstance(system.optimizer, topt.Adan)
    events = (tmp_path / "logs" / "events.tsv").read_text().splitlines()
    assert {line.split("\t")[1] for line in events} == {"1", "2"}
    assert any(line.split("\t")[2] == "loss" for line in events)
    (tb,) = os.listdir(tmp_path / "tb")
    assert tb.startswith("events.out.tfevents.") and os.path.getsize(tmp_path / "tb" / tb) > 100
    assert (tmp_path / "progress").read_text() == "Generating: 100.0%\n"
