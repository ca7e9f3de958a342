"""Components of the ported path (importing registers them)."""

from dreammat_tpu_torch.models import (  # noqa: F401
    exporter, geometry, guidance, guidance_sds, guidance_triple, material, prompt, renderer,
)
