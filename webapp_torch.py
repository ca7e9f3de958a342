"""Minimal web UI for material generation with the PyTorch/CUDA port.

The port's own copy of ``webapp.py``, standard library only: an HTML form
posts a (mesh path, prompt, steps, config) job; the server spawns
``python launch_torch.py --train ...`` on the device its ``--device``
names (``job_command``), shows the progress file's percentage, and serves
the latest render and gif of the trial. Jobs past the running one wait in a bounded FIFO queue; a watchdog
kills a run that passes the hard timeout, stops updating its progress
file, or (opt-in) loses its UI poll; a shared token (``--token`` or
``DREAMMAT_WEBAPP_TOKEN``) guards every request when set.

Usage: python webapp_torch.py --port 7860 [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import hmac
import html
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

STATE = {
    "proc": None,
    "trial_dir": None,
    "started": None,
    "cmd": None,
    "killed": None,       # watchdog kill reason, shown in status
    "last_poll": None,    # last UI status poll (the reference's `alive` file)
    "queue": [],          # pending job dicts (cmd, trial_dir), FIFO
    "done": [],           # (cmd, outcome) history of retired jobs
}
LOCK = threading.Lock()

# parity-plus over the reference's single global slot: submissions past the
# running job wait in a bounded FIFO and start as the slot frees up
MAX_QUEUE = 4

# optional shared-secret auth (--token / DREAMMAT_WEBAPP_TOKEN); None = open
# (reference gradio_app.py has no auth either — this is opt-in hardening)
AUTH_TOKEN = os.environ.get("DREAMMAT_WEBAPP_TOKEN") or None


def authorized(headers, query, form=None) -> bool:
    """True when no token is configured, or the request carries it via
    ``Authorization: Bearer <token>`` (preferred), ``?token=``, or a form
    field. Comparisons are constant-time. NOTE: ``?token=`` exists only so
    <img> previews work without headers; query-string secrets leak into
    access logs / browser history — use the Bearer header from scripts."""
    if AUTH_TOKEN is None:
        return True

    def _eq(candidate) -> bool:
        return isinstance(candidate, str) and hmac.compare_digest(
            candidate.encode(), AUTH_TOKEN.encode())

    auth = headers.get("Authorization", "") if hasattr(headers, "get") else ""
    if auth.startswith("Bearer ") and _eq(auth[len("Bearer "):]):
        return True
    for source in (query, form):
        if source and _eq(source.get("token", [None])[0]):
            return True
    return False


def _start_job_locked(job, popen):
    """Start ``job`` in the (free) slot. Caller holds LOCK."""
    proc = popen(job["cmd"])
    STATE["proc"] = proc
    STATE["trial_dir"] = job["trial_dir"]
    STATE["started"] = time.time()
    STATE["cmd"] = job["cmd"]
    STATE["killed"] = None
    STATE["last_poll"] = time.time()
    threading.Thread(
        target=_watchdog_loop, args=(proc, job["trial_dir"]),
        kwargs={"popen": popen}, daemon=True,
    ).start()


def submit_job(job, popen=subprocess.Popen):
    """Submit a job dict ({"cmd", "trial_dir"}): starts it if the slot is
    free AND no earlier job is waiting, else queues it (bounded FIFO — a
    new POST never jumps ahead of already-queued jobs). Returns
    ("started", None), ("queued", position) or ("rejected", reason)."""
    with LOCK:
        slot_free = STATE["proc"] is None or STATE["proc"].poll() is not None
        if slot_free:
            _retire_finished_locked()
            if not STATE["queue"]:
                _start_job_locked(job, popen)
                return ("started", None)
            # FIFO: the head of the queue takes the free slot; this
            # submission waits its turn behind the rest
            if len(STATE["queue"]) >= MAX_QUEUE:
                return ("rejected", f"queue full ({MAX_QUEUE} pending)")
            STATE["queue"].append(job)
            _start_job_locked(STATE["queue"].pop(0), popen)
            return ("queued", len(STATE["queue"]))
        if len(STATE["queue"]) >= MAX_QUEUE:
            return ("rejected", f"queue full ({MAX_QUEUE} pending)")
        STATE["queue"].append(job)
        return ("queued", len(STATE["queue"]))


def _retire_finished_locked():
    """Move a finished slot into the done history. Caller holds LOCK."""
    proc = STATE["proc"]
    if proc is None or proc.poll() is None:
        return
    outcome = (f"killed: {STATE['killed']}" if STATE["killed"]
               else f"exit {proc.returncode}")
    STATE["done"].append((STATE["cmd"], outcome))
    STATE["proc"] = None


def pump_queue(popen=subprocess.Popen):
    """Advance the queue: if the slot's job finished, retire it and start
    the next queued job. Returns the started job dict or None. Called on
    every status poll (no dedicated scheduler thread to leak)."""
    with LOCK:
        proc = STATE["proc"]
        if proc is not None and proc.poll() is None:
            return None
        _retire_finished_locked()
        if not STATE["queue"]:
            return None
        job = STATE["queue"].pop(0)
        _start_job_locked(job, popen)
        return job

# Watchdog defaults (reference gradio_app.py:460-510 semantics: SIGKILL hung
# or abandoned runs). hard/stale are generous because first-compile of
# SD-sized models takes minutes; alive (UI-poll) is opt-in like the
# reference's `watch` mode.
HARD_TIMEOUT = 4 * 3600   # max total run seconds
STALE_TIMEOUT = 1800      # max seconds without a progress-file update
ALIVE_TIMEOUT = 0         # 0 = disabled; else max seconds between UI polls
WATCH_INTERVAL = 5.0


def watchdog_reason(now, started, progress_mtime, last_poll,
                    hard_timeout=None, stale_timeout=None, alive_timeout=None):
    """Pure kill-decision (testable): returns a reason string or None.

    Mirrors gradio_app.py:484-500 loop_check_alive: stale heartbeat =>
    SIGKILL; plus a hard wall-clock cap (the reference run() generator's
    EXP timeouts)."""
    hard = HARD_TIMEOUT if hard_timeout is None else hard_timeout
    stale = STALE_TIMEOUT if stale_timeout is None else stale_timeout
    alive = ALIVE_TIMEOUT if alive_timeout is None else alive_timeout
    if started is None:
        return None
    if hard and now - started > hard:
        return f"hard timeout ({hard}s)"
    # progress staleness counts from the later of start / last update so a
    # long compile before the first progress write isn't mistaken for a hang
    last_progress = max(started, progress_mtime or 0.0)
    if stale and now - last_progress > stale:
        return f"stale progress ({stale}s without update)"
    if alive and last_poll is not None and now - last_poll > alive:
        return f"UI abandoned ({alive}s without poll)"
    return None


def _watchdog_loop(proc, trial_dir, hard_timeout=None, stale_timeout=None,
                   alive_timeout=None, interval=WATCH_INTERVAL,
                   popen=subprocess.Popen):
    progress_path = os.path.join(trial_dir, "progress")
    while proc.poll() is None:
        now = time.time()
        with LOCK:
            started = STATE["started"] if STATE["proc"] is proc else None
            last_poll = STATE["last_poll"]
        mtime = os.path.getmtime(progress_path) if os.path.exists(progress_path) else None
        reason = watchdog_reason(now, started, mtime, last_poll,
                                 hard_timeout, stale_timeout, alive_timeout)
        if reason is not None:
            proc.kill()  # SIGKILL, gradio_app.py:495
            proc.wait()
            with LOCK:
                if STATE["proc"] is proc:
                    STATE["killed"] = reason
            break
        time.sleep(interval)
    # the child is gone either way: advance the queue now so progress does
    # not depend on a browser tab still polling status_text()
    pump_queue(popen=popen)

PAGE = """<!doctype html><html><head><title>dreammat (PyTorch/CUDA)</title>
<style>body{{font-family:sans-serif;max-width:720px;margin:2em auto}}
input,button{{font-size:1em;padding:.3em}}img{{max-width:100%}}</style>
</head><body>
<h2>DreamMat material generation</h2>
<form method="post" action="/run">
  <p>Mesh path: <input name="mesh" size="50" value="{mesh}"></p>
  <p>Prompt: <input name="prompt" size="50" value="{prompt}"></p>
  <p>Steps: <input name="steps" size="8" value="{steps}">
     Config: <input name="config" size="30" value="{config}"></p>
  <button type="submit">Generate</button>
</form>
<div id="status">{status}</div>
{preview}
<script>setTimeout(()=>location.reload(), 5000)</script>
</body></html>"""


def status_text():
    pump_queue()  # poll-driven scheduler: start the next queued job
    with LOCK:
        proc = STATE["proc"]
        trial = STATE["trial_dir"]
        killed = STATE["killed"]
        pending = len(STATE["queue"])
        history = STATE["done"][-3:]
        STATE["last_poll"] = time.time()  # UI heartbeat (reference `alive` file)
    suffix = f" | {pending} queued" if pending else ""
    for cmd, outcome in history:
        suffix += f" | done: {' '.join(map(str, cmd[-2:]))} ({outcome})"
    if proc is None:
        return "idle" + suffix, ""
    progress = ""
    if trial and os.path.exists(os.path.join(trial, "progress")):
        progress = open(os.path.join(trial, "progress")).read().strip()
    if proc.poll() is None:
        return f"running ({progress}){suffix}", preview_html(trial)
    if killed:
        return f"killed by watchdog: {killed}{suffix}", preview_html(trial)
    return (f"finished (exit {proc.returncode}) {progress}{suffix}",
            preview_html(trial))


def preview_html(trial):
    if not trial:
        return ""
    imgs = sorted(glob.glob(os.path.join(trial, "save", "*.png")))
    gifs = sorted(glob.glob(os.path.join(trial, "save", "*.gif")))
    parts = []
    for p in (imgs[-1:] + gifs[-1:]):
        rel = os.path.relpath(p, start=os.getcwd())
        parts.append(f'<p><img src="/file?path={html.escape(rel)}"></p>')
    return "\n".join(parts)


# the device every job runs on (--device): "cuda", "cuda:N" or "cpu"
JOB_DEVICE = "cuda"


def job_command(mesh: str, prompt: str, steps, config: str) -> dict:
    """The job of a form: ``launch_torch.py --train`` on the mesh and prompt
    on ``JOB_DEVICE``, its trial under ``outputs/webapp``."""
    tag = prompt.replace(" ", "_") or "job"
    cmd = [
        sys.executable, "launch_torch.py", "--config", config, "--train",
        "--device", JOB_DEVICE,
        f"system.prompt_processor.prompt={prompt}",
        f"system.geometry.shape_init=mesh:{mesh}",
        f"trainer.max_steps={steps}",
        "exp_root_dir=outputs/webapp", "use_timestamp=false",
    ]
    return {"cmd": cmd, "trial_dir": os.path.join("outputs", "webapp", tag)}


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, body: bytes, ctype="text/html"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        if not authorized(self.headers, parse_qs(url.query)):
            self.send_error(403, "missing or invalid token")
            return
        if url.path == "/file":
            q = parse_qs(url.query)
            path = q.get("path", [""])[0]
            # serve only files under cwd
            full = os.path.abspath(path)
            if not full.startswith(os.getcwd()) or not os.path.exists(full):
                self.send_error(404)
                return
            ctype = "image/gif" if full.endswith(".gif") else "image/png"
            with open(full, "rb") as f:
                self._send(f.read(), ctype)
            return
        status, preview = status_text()
        body = PAGE.format(
            mesh="", prompt="", steps="3000", config="configs/dreammat.yaml",
            status=html.escape(status), preview=preview,
        )
        self._send(body.encode())

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        form = parse_qs(self.rfile.read(length).decode())
        if not authorized(self.headers, parse_qs(urlparse(self.path).query),
                          form):
            self.send_error(403, "missing or invalid token")
            return
        mesh = form.get("mesh", [""])[0]
        prompt = form.get("prompt", [""])[0]
        steps = form.get("steps", ["3000"])[0]
        config = form.get("config", ["configs/dreammat.yaml"])[0]
        outcome, detail = submit_job(job_command(mesh, prompt, steps, config))
        if outcome == "rejected":
            self._send(f"{html.escape(str(detail))}; "
                       f"<a href='/'>back</a>".encode())
            return
        self.send_response(303)
        self.send_header("Location", "/")
        self.end_headers()


def main():
    global HARD_TIMEOUT, STALE_TIMEOUT, ALIVE_TIMEOUT, AUTH_TOKEN, JOB_DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default=JOB_DEVICE,
                    help="device of every job's launch_torch.py: cuda (default), cuda:N or cpu")
    ap.add_argument("--token", default=AUTH_TOKEN,
                    help="require this shared secret on every request "
                         "(Bearer header, ?token=, or form field); also "
                         "settable via DREAMMAT_WEBAPP_TOKEN. Default: open.")
    ap.add_argument("--hard-timeout", type=int, default=HARD_TIMEOUT,
                    help="SIGKILL the run after this many seconds total (0=off)")
    ap.add_argument("--stale-timeout", type=int, default=STALE_TIMEOUT,
                    help="SIGKILL if the progress file stops updating (0=off)")
    ap.add_argument("--alive-timeout", type=int, default=ALIVE_TIMEOUT,
                    help="SIGKILL if no UI poll for this long (0=off; "
                         "reference gradio_app.py watch mode)")
    args = ap.parse_args()
    HARD_TIMEOUT = args.hard_timeout
    STALE_TIMEOUT = args.stale_timeout
    ALIVE_TIMEOUT = args.alive_timeout
    AUTH_TOKEN = args.token or None
    JOB_DEVICE = args.device
    server = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"serving on http://localhost:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
