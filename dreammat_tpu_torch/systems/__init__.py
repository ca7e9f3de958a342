"""Training systems (importing registers them)."""

from dreammat_tpu_torch.systems import dreammat  # noqa: F401
