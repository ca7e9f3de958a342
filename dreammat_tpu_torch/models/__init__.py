"""Components of the ported path (importing registers them)."""

from dreammat_tpu_torch.models import (  # noqa: F401
    background, exporter, gan_renderer, geometry, geometry_dmtet, geometry_sdf, geometry_volume,
    guidance, guidance_deepfloyd, guidance_ip2p, guidance_sds, guidance_triple, guidance_unified,
    guidance_vsd, guidance_zero123, material, material_pbr, material_simple, mesh_rasterizer,
    prompt, prompt_deepfloyd, renderer, volume_renderer,
)
