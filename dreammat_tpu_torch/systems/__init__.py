"""Training systems (importing registers them)."""

from dreammat_tpu_torch.systems import controlnet_trainer, dreammat, texcraft  # noqa: F401
