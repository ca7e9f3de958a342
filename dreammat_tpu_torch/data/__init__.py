"""Cameras, prerender and the data module (importing registers them)."""

from dreammat_tpu_torch.data import co3d, datamodule, image, multiview  # noqa: F401
