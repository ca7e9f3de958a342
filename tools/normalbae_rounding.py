"""How far fp32 rounding alone moves the port's NormalBae control image.

Builds the random-weight NormalBae of the triple guidance (``load_normalbae``
without weights), takes its BatchNorm statistics from the input as
``chip_smoke.py`` path 6 does (``batchnorm_from_input``), and holds its fp32
``detect`` against its fp64 one, once per trial. The input is a smooth image
(bilinear from 16^2 noise) plus 1e-6 noise (``--image noise``), or a 512^2
render of a self-occluding torus (its face normals as colour on a flat
background of ``--background``, cast through the plain BVH walk;
``--image torus``). Prints the largest difference and the share of values
over one 8-bit level (1/255), the tolerance of path 6's NormalBae check;
with ``--folded`` also the same with PyTorch's own BatchNorm inference
(x * a + b, what ``CenteredBatchNorm2d`` replaces), and the largest
|mean| / sqrt(var + eps) of any BatchNorm channel, where that folding
loses digits. ``--layers`` prints, stage by stage, the fp32 output's
largest error against fp64 relative to its largest value, and the length
of the decoder's raw normal where the control image is furthest off (the
final normalisation divides the raw error by it). Runs on the CPU unless
``--device``:

    python3 tools/normalbae_rounding.py --trials 3
    python3 tools/normalbae_rounding.py --image torus --background 0.5 --folded
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def torus_render(res: int, background: float) -> torch.Tensor:
    """[1,3,res,res]: the torus of main path 3 seen from (elevation 30,
    azimuth 20, distance 2.5, fovy 45), 0.4 + 0.4 n where it is hit."""
    from dreammat_tpu_torch.models.mesh import torus_arrays
    from dreammat_tpu_torch.models.renderer import _views_rays
    from dreammat_tpu_torch.ops import bvh as bvh_lib

    v, f = torus_arrays(0.7, 0.28, 192, 96)
    b = bvh_lib.build_bvh(v, f, device="cpu")
    one = lambda x: torch.tensor([x], dtype=torch.float32)
    _, _, ro, rd = _views_rays(one(30.0), one(20.0), one(2.5), one(45.0), res, res)
    out = bvh_lib.cast_rays_bvh_plain(b, ro.reshape(-1, 3), rd.reshape(-1, 3))
    tri = torch.as_tensor(v)[torch.as_tensor(f)[out["face"].clamp(min=0)]]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    n = n / n.norm(dim=-1, keepdim=True)
    img = torch.where(out["hit"][:, None], (n * 0.5 + 0.5) * 0.8, torch.full((1, 3), background))
    return img.reshape(res, res, 3).permute(2, 0, 1)[None].contiguous()


def stage_errors(m, rgb: torch.Tensor) -> None:
    """The fp32 forward of ``m`` against its fp64 copy, stage by stage."""
    import copy

    from dreammat_tpu_torch.models import detectors

    enc = m.encoder.original_model
    stages = {"stem": enc.bn1, **{f"encoder stage {i}": b for i, b in enumerate(enc.blocks)},
              "encoder head": enc.conv_head, "decoder up4": m.decoder.up4,
              "raw normal (res1 head)": m.decoder.out_conv_res1}
    outs = ({}, {})
    m64 = copy.deepcopy(m).double()
    hooks = []
    for name, mod in stages.items():
        mod64 = dict(m64.named_modules())[next(n for n, x in m.named_modules() if x is mod)]
        for side, module in ((0, mod), (1, mod64)):
            hooks.append(module.register_forward_hook(
                lambda _m, _i, o, side=side, name=name: outs[side].__setitem__(name, o.detach())))
    raw = ([], [])
    real = detectors.norm_normalize
    detectors.norm_normalize = lambda out: (raw[out.dtype == torch.float64].append(out), real(out))[1]
    try:
        with torch.no_grad():
            img32 = m.detect(rgb).double()
            img64 = m64.detect(rgb.double())
    finally:
        detectors.norm_normalize = real
        for h in hooks:
            h.remove()
    for name in stages:
        a, b = outs[0][name].double(), outs[1][name]
        print(f"  {name}: largest |fp32 - fp64| / largest |fp64| "
              f"{((a - b).abs().max() / b.abs().max()).item():.3e}", flush=True)
    err = (img32 - img64).abs().amax(1)[0]   # [H, W], the image's channels
    n = raw[1][-1][0, :3].norm(dim=0)        # the last head's raw normal, [H, W]
    k = int(err.flatten().argmax())
    print(f"  control image furthest off ({err.flatten()[k].item():.3e}) where the raw normal's "
          f"length is {n.flatten()[k].item():.3e} (smallest {n.min().item():.3e})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512, help="the image's side")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--image", choices=("noise", "torus"), default="noise")
    ap.add_argument("--background", type=float, default=1.0, help="the torus render's")
    ap.add_argument("--folded", action="store_true",
                    help="also with PyTorch's folded BatchNorm inference")
    ap.add_argument("--layers", action="store_true", help="the error stage by stage")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke
    from dreammat_tpu_torch.models import detectors

    model = detectors.load_normalbae(None, args.device)
    gen = torch.Generator().manual_seed(0)
    base = torch.nn.functional.interpolate(torch.rand(1, 3, 16, 16, generator=gen),
                                           size=(args.res, args.res), mode="bilinear",
                                           align_corners=False)
    centred = detectors.CenteredBatchNorm2d.forward
    forms = {"centred": centred}
    if args.folded:
        forms["folded"] = torch.nn.BatchNorm2d.forward
    for trial in range(args.trials):
        if args.image == "torus":
            rgb = torus_render(args.res, args.background).to(args.device)
        else:
            rgb = (base + 1e-6 * torch.randn(base.shape, generator=gen)).clamp(0, 1)
            rgb = rgb.to(args.device)
        m = chip_smoke.batchnorm_from_input(model, rgb)
        ratio = max((bn.running_mean.abs() / (bn.running_var + bn.eps).sqrt()).max().item()
                    for bn in m.modules() if isinstance(bn, torch.nn.BatchNorm2d))
        with torch.no_grad():
            out64 = m.double().detect(rgb.double())
            m.float()
            for name, fwd in forms.items():
                detectors.CenteredBatchNorm2d.forward = fwd
                try:
                    out32 = m.detect(rgb).double()
                finally:
                    detectors.CenteredBatchNorm2d.forward = centred
                d = (out64 - out32).abs()
                print(f"trial {trial} ({args.image}, BatchNorm {name}): fp32 against fp64 "
                      f"max|diff| {d.max().item():.6e}, share over 1/255 "
                      f"{(d > 1 / 255).double().mean().item():.6e}; largest BatchNorm "
                      f"|mean|/sqrt(var+eps) {ratio:.3f}", flush=True)
        if args.layers:
            stage_errors(m, rgb)
        if args.image == "torus":
            break  # the render is the same every trial
    return 0


if __name__ == "__main__":
    sys.exit(main())
