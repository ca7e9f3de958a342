"""Components of the ported path (importing registers them)."""

from dreammat_tpu_torch.models import (  # noqa: F401
    background, exporter, geometry, geometry_dmtet, geometry_sdf, geometry_volume, guidance,
    guidance_sds, guidance_triple, guidance_vsd, material, material_pbr, material_simple,
    mesh_rasterizer, prompt, renderer, volume_renderer,
)
