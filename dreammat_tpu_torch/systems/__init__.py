"""Training systems (importing registers them)."""

from dreammat_tpu_torch.systems import (  # noqa: F401
    control4d, controlnet_trainer, dreamfusion, dreammat, fantasia3d, instructnerf2nerf,
    latentnerf, magic123, magic3d, prolificdreamer, sjc, texcraft, textmesh, zero123,
)
