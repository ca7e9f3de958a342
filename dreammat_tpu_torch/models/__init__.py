"""Components of the ported path (importing registers them)."""

from dreammat_tpu_torch.models import (  # noqa: F401
    exporter, geometry, guidance, material, prompt, renderer,
)
