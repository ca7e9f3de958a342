"""Cameras, prerender and the data module (importing registers them)."""

from dreammat_tpu_torch.data import datamodule  # noqa: F401
