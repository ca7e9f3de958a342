"""Components of the ported path (importing registers them)."""

from dreammat_tpu_torch.models import geometry, guidance, material, prompt, renderer  # noqa: F401
