"""The port's apps: the 2D playground and the web app.

- ``playground_2d_torch.main`` at tiny size on the CPU writes ``final.png``
  (and the first step's PNG) with finite losses, and without
  ``--device cpu`` it raises for want of a GPU. Its start is not the exact
  gray of ``playground_2d.py``, where the random SD2.1-size VAE's gradient
  is not finite (shown in both packages).
- ``webapp_torch``: the cases of ``tests/test_webapp.py`` (watchdog, FIFO
  queue, token auth) against the port's copy, and a form posted to the
  server on the loopback interface becomes a ``launch_torch.py --train``
  job.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import playground_2d_torch
import webapp_torch
from test_torch_dreammat_step import _numpy_random_init
from torch_threads import one_thread  # noqa: F401


def test_playground_tiny_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the prompt processor's embedding cache
    out = str(tmp_path / "pg")
    res = playground_2d_torch.main(["--prompt", "a red apple", "--steps", "3", "--size", "32",
                                    "--out", out, "--device", "cpu"])
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert sorted(os.listdir(out)) == ["final.png", "step00001.png"]
    with open(res["final"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert type(res["guidance"]).__name__ == "StableDiffusionLightGuidance"
    assert not res["guidance"].controlnets


def test_exact_gray_start_overflows_the_vae_gradient():
    """Why the playground does not start at the exact gray of
    ``playground_2d.py``: with random SD2.1-size VAE weights (zero biases)
    the gradient of the sampled latents with respect to a gray 128^2 image
    is not finite in either package; from the playground's start it is."""
    import jax
    import jax.numpy as jnp

    from dreammat_tpu.models.diffusion.vae import AutoencoderKL as JVAE
    from dreammat_tpu.models.diffusion.vae import VAEConfig as JVAEConfig
    from dreammat_tpu_torch.models.diffusion.convert import random_init_
    from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig

    jvae = JVAE(JVAEConfig.sd())
    # fast_random_init's fill, from numpy; the weights enter the jitted
    # gradient as an argument (closed over, XLA folds them as constants)
    params = _numpy_random_init(
        jax.random.PRNGKey(0), lambda: jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    jgrad = jax.jit(jax.grad(lambda x, p: jnp.sum(jvae.apply(
        p, x * 2 - 1, jax.random.PRNGKey(2), method=jvae.encode) ** 2)))(
        jnp.full((1, 128, 128, 3), 0.5), params)
    assert not bool(jnp.isfinite(jgrad).all())

    vae = AutoencoderKL(VAEConfig.sd())
    with torch.no_grad():
        random_init_(vae, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)  # the playground's start, seed 0
    eps = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(3))
    for x, finite in ((torch.full((1, 3, 128, 128), 0.5), False),
                      (0.5 + (torch.rand((1, 3, 128, 128), generator=gen) - 0.5) / 255.0, True)):
        x.requires_grad_(True)
        (vae.encode(x * 2 - 1, eps) ** 2).sum().backward()  # the posterior sample
        assert bool(torch.isfinite(x.grad).all()) == finite


def test_playground_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        playground_2d_torch.main(["--prompt", "x", "--steps", "1", "--out", str(tmp_path)])


def test_job_command_runs_launch_torch(monkeypatch):
    job = webapp_torch.job_command("meshes/a.obj", "a red apple", "30", "configs/texcraft.yaml")
    cmd = job["cmd"]
    assert cmd[0] == sys.executable and cmd[1] == "launch_torch.py"
    assert cmd[2:7] == ["--config", "configs/texcraft.yaml", "--train", "--device", "cuda"]
    monkeypatch.setattr(webapp_torch, "JOB_DEVICE", "cpu")
    assert webapp_torch.job_command("m.obj", "x", "1", "c.yaml")["cmd"][5:7] == ["--device", "cpu"]
    assert "system.geometry.shape_init=mesh:meshes/a.obj" in cmd
    assert "system.prompt_processor.prompt=a red apple" in cmd
    assert "trainer.max_steps=30" in cmd
    assert job["trial_dir"] == os.path.join("outputs", "webapp", "a_red_apple")


def test_posted_form_submits_a_launch_torch_job(monkeypatch):
    """The server on 127.0.0.1 (an ephemeral port): a POST of the form
    reaches ``submit_job`` with ``launch_torch.py``; the page answers."""
    import threading
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    jobs = []
    monkeypatch.setattr(webapp_torch, "submit_job", lambda job: jobs.append(job) or
                        ("queued", 1))
    monkeypatch.setattr(webapp_torch, "AUTH_TOKEN", "s3cret")
    server = ThreadingHTTPServer(("127.0.0.1", 0), webapp_torch.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        form = urllib.parse.urlencode({"mesh": "m.obj", "prompt": "a vase", "steps": "5",
                                       "config": "configs/dreammat.yaml"}).encode()
        req = urllib.request.Request(base + "/run", data=form,
                                     headers={"Authorization": "Bearer s3cret"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200  # the redirect to / is followed, with the header
            assert b"DreamMat material generation" in r.read()
        with pytest.raises(urllib.error.HTTPError, match="403"):
            urllib.request.urlopen(base + "/", timeout=30)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert len(jobs) == 1 and jobs[0]["cmd"][1] == "launch_torch.py"
    assert "system.prompt_processor.prompt=a vase" in jobs[0]["cmd"]


def test_watchdog_reason_pure():
    f = webapp_torch.watchdog_reason
    # healthy: just started, fresh progress
    assert f(100.0, 90.0, 95.0, 99.0, 3600, 600, 0) is None
    # hard timeout
    r = f(5000.0, 100.0, 4999.0, 4999.0, 3600, 600, 0)
    assert r and "hard" in r
    # stale progress (no update since start + stale window)
    r = f(1000.0, 100.0, 200.0, 999.0, 3600, 600, 0)
    assert r and "stale" in r
    # stale counts from start when no progress file yet (long compile OK)
    assert f(400.0, 100.0, None, 399.0, 3600, 600, 0) is None
    r = f(800.0, 100.0, None, 799.0, 3600, 600, 0)
    assert r and "stale" in r
    # alive (UI poll) timeout only when enabled
    assert f(1000.0, 900.0, 999.0, 100.0, 3600, 600, 0) is None
    r = f(1000.0, 900.0, 999.0, 100.0, 3600, 600, 30)
    assert r and "abandoned" in r
    # not started => never kill
    assert f(1e9, None, None, None, 1, 1, 1) is None


def test_watchdog_kills_hung_process(tmp_path):
    """Integration: a subprocess that never writes progress is SIGKILLed
    once the stale window expires."""
    trial = tmp_path / "trial"
    trial.mkdir()
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    with webapp_torch.LOCK:
        webapp_torch.STATE.update(
            proc=proc, trial_dir=str(trial), started=time.time(),
            killed=None, last_poll=time.time(),
        )
    try:
        webapp_torch._watchdog_loop(
            proc, str(trial), hard_timeout=0, stale_timeout=1,
            alive_timeout=0, interval=0.2,
        )
        assert proc.poll() is not None  # killed
        with webapp_torch.LOCK:
            assert webapp_torch.STATE["killed"] and "stale" in webapp_torch.STATE["killed"]
    finally:
        if proc.poll() is None:
            proc.kill()
        with webapp_torch.LOCK:
            webapp_torch.STATE.update(proc=None, trial_dir=None, started=None,
                                killed=None, last_poll=None)


def test_watchdog_spares_progressing_process(tmp_path):
    """A run that keeps updating its progress file is NOT killed."""
    trial = tmp_path / "trial"
    trial.mkdir()
    prog = trial / "progress"
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(2.0)"])
    with webapp_torch.LOCK:
        webapp_torch.STATE.update(
            proc=proc, trial_dir=str(trial), started=time.time(),
            killed=None, last_poll=time.time(),
        )
    import threading

    stop = threading.Event()

    def beat():
        while not stop.is_set():
            prog.write_text("Generating: 1.0%\n")
            time.sleep(0.2)

    t = threading.Thread(target=beat, daemon=True)
    t.start()
    try:
        webapp_torch._watchdog_loop(
            proc, str(trial), hard_timeout=0, stale_timeout=1,
            alive_timeout=0, interval=0.2,
        )
        # loop exits because the process finished, not because it was killed
        with webapp_torch.LOCK:
            assert webapp_torch.STATE["killed"] is None
        assert proc.returncode == 0
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
        with webapp_torch.LOCK:
            webapp_torch.STATE.update(proc=None, trial_dir=None, started=None,
                                killed=None, last_poll=None)


class _FakeProc:
    """Stands in for subprocess.Popen: alive until .finish() is called."""

    def __init__(self, cmd):
        self.cmd = cmd
        self.returncode = None

    def poll(self):
        return self.returncode

    def finish(self, code=0):
        self.returncode = code

    def kill(self):
        self.returncode = -9

    def wait(self):
        return self.returncode


def _reset_state():
    with webapp_torch.LOCK:
        webapp_torch.STATE.update(proc=None, trial_dir=None, started=None, cmd=None,
                            killed=None, last_poll=None, queue=[], done=[])


def test_queue_two_jobs_run_in_order(monkeypatch):
    """Parity-plus over the reference's single global slot (VERDICT r3 #9):
    a second submission queues and starts when the first finishes."""
    _reset_state()
    # the real _start_job_locked spawns a watchdog thread; FakeProc poll()
    # keeps it harmless (no started timeout configured below 4 h)
    j1 = {"cmd": ["job1"], "trial_dir": "/tmp/t1"}
    j2 = {"cmd": ["job2"], "trial_dir": "/tmp/t2"}
    out1 = webapp_torch.submit_job(j1, popen=_FakeProc)
    assert out1 == ("started", None)
    out2 = webapp_torch.submit_job(j2, popen=_FakeProc)
    assert out2 == ("queued", 1)
    # slot busy: pump does nothing
    assert webapp_torch.pump_queue(popen=_FakeProc) is None
    with webapp_torch.LOCK:
        first = webapp_torch.STATE["proc"]
        assert first.cmd == ["job1"]
    first.finish(0)
    started = webapp_torch.pump_queue(popen=_FakeProc)
    assert started is j2
    with webapp_torch.LOCK:
        assert webapp_torch.STATE["proc"].cmd == ["job2"]
        assert webapp_torch.STATE["queue"] == []
        assert webapp_torch.STATE["done"] == [(["job1"], "exit 0")]
    _reset_state()


def test_queue_bounded_and_fifo():
    _reset_state()
    webapp_torch.submit_job({"cmd": ["a"], "trial_dir": "t"}, popen=_FakeProc)
    for i in range(webapp_torch.MAX_QUEUE):
        out = webapp_torch.submit_job({"cmd": [f"q{i}"], "trial_dir": "t"},
                                popen=_FakeProc)
        assert out == ("queued", i + 1)
    outcome, reason = webapp_torch.submit_job({"cmd": ["overflow"], "trial_dir": "t"},
                                        popen=_FakeProc)
    assert outcome == "rejected" and "full" in reason
    _reset_state()


def test_submit_never_jumps_queue():
    """ADVICE r4 (medium): when the slot freed up but earlier jobs are still
    queued, a new POST takes its place BEHIND them — the queue head starts."""
    _reset_state()
    webapp_torch.submit_job({"cmd": ["a"], "trial_dir": "t"}, popen=_FakeProc)
    webapp_torch.submit_job({"cmd": ["b"], "trial_dir": "t"}, popen=_FakeProc)
    with webapp_torch.LOCK:
        webapp_torch.STATE["proc"].finish(0)  # slot free, but "b" is queued
    out = webapp_torch.submit_job({"cmd": ["c"], "trial_dir": "t"}, popen=_FakeProc)
    assert out == ("queued", 1)  # c waits behind b
    with webapp_torch.LOCK:
        assert webapp_torch.STATE["proc"].cmd == ["b"]  # head of queue started
        assert [j["cmd"] for j in webapp_torch.STATE["queue"]] == [["c"]]
    _reset_state()


def test_watchdog_pumps_queue_on_exit():
    """ADVICE r4 (medium): queued jobs advance when the child exits even if
    no browser tab is polling status_text()."""
    _reset_state()
    webapp_torch.submit_job({"cmd": ["first"], "trial_dir": "/tmp/t1"},
                      popen=_FakeProc)
    webapp_torch.submit_job({"cmd": ["second"], "trial_dir": "/tmp/t2"},
                      popen=_FakeProc)
    with webapp_torch.LOCK:
        proc = webapp_torch.STATE["proc"]
    proc.finish(0)
    # drive the watchdog loop directly (the spawned thread uses 5s polls)
    webapp_torch._watchdog_loop(proc, "/tmp/t1", hard_timeout=0, stale_timeout=0,
                          alive_timeout=0, interval=0.01, popen=_FakeProc)
    with webapp_torch.LOCK:
        assert webapp_torch.STATE["proc"].cmd == ["second"]
        assert webapp_torch.STATE["queue"] == []
    _reset_state()


def test_auth_token():
    """Requests carry the token via bearer header, query, or form; missing
    or wrong tokens are refused (no token configured = open)."""
    old = webapp_torch.AUTH_TOKEN
    try:
        webapp_torch.AUTH_TOKEN = None
        assert webapp_torch.authorized({}, {})
        webapp_torch.AUTH_TOKEN = "s3cret"
        assert not webapp_torch.authorized({}, {})
        assert not webapp_torch.authorized({"Authorization": "Bearer wrong"}, {})
        assert webapp_torch.authorized({"Authorization": "Bearer s3cret"}, {})
        assert webapp_torch.authorized({}, {"token": ["s3cret"]})
        assert webapp_torch.authorized({}, {}, {"token": ["s3cret"]})
        assert not webapp_torch.authorized({}, {"token": ["nope"]})
    finally:
        webapp_torch.AUTH_TOKEN = old
