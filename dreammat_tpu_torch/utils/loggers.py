"""Metric logging + progress reporting.

The port's copy of ``dreammat_tpu/utils/loggers.py``, dependency-light
equivalents of a Lightning logger stack:

- CSVLogger: append-only metrics.csv (Lightning CSVLogger layout)
- TSVEventLogger: simple tag<TAB>step<TAB>value event stream, tail-able
- ProgressWriter: the gradio progress-file protocol (step/total percent)
- WandbLogger: used only if the wandb package exists
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Dict, Optional


class CSVLogger:
    def __init__(self, out_dir: str, name: str = "metrics.csv"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, name)
        self._fieldnames = None

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        write_header = not os.path.exists(self.path)
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


class TSVEventLogger:
    def __init__(self, out_dir: str, name: str = "events.tsv"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, name)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        t = time.time()
        with open(self.path, "a") as f:
            for k, v in metrics.items():
                f.write(f"{t:.3f}\t{step}\t{k}\t{float(v):.6g}\n")


class ProgressWriter:
    """The gradio progress-file protocol: a file containing
    'Generating: {percent}%'."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def update(self, step: int, total: int) -> None:
        pct = 100.0 * step / max(total, 1)
        with open(self.path, "w") as f:
            f.write(f"Generating: {pct:.1f}%\n")


class WandbLogger:
    def __init__(self, project: str, name: Optional[str] = None, enable: bool = True):
        self.run = None
        if not enable:
            return
        try:
            import wandb  # optional; without it nothing is logged

            self.run = wandb.init(project=project, name=name)
        except Exception:
            self.run = None

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self.run is not None:
            self.run.log({k: float(v) for k, v in metrics.items()}, step=step)


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for l in self.loggers:
            l.log(metrics, step)
