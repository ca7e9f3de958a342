"""How far fp32 rounding alone moves the port's NormalBae control image.

Builds the random-weight NormalBae of the triple guidance (``load_normalbae``
without weights), takes its BatchNorm statistics from the input as
``chip_smoke.py`` path 6 does (``batchnorm_from_input``), and holds its fp32
``detect`` against its fp64 one on a smooth image (bilinear from 16^2 noise)
plus 1e-6 noise, once per trial. Prints the largest difference and the
share of values over one 8-bit level (1/255), the tolerance of path 6's
card-against-CPU NormalBae check. Runs on the CPU unless ``--device``:

    python3 tools/normalbae_rounding.py --trials 3
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512, help="the image's side")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke
    from dreammat_tpu_torch.models.detectors import load_normalbae

    model = load_normalbae(None, args.device)
    gen = torch.Generator().manual_seed(0)
    base = torch.nn.functional.interpolate(torch.rand(1, 3, 16, 16, generator=gen),
                                           size=(args.res, args.res), mode="bilinear",
                                           align_corners=False)
    for trial in range(args.trials):
        rgb = (base + 1e-6 * torch.randn(base.shape, generator=gen)).clamp(0, 1).to(args.device)
        m = chip_smoke.batchnorm_from_input(model, rgb)
        with torch.no_grad():
            out32 = m.detect(rgb).double()
            out64 = m.double().detect(rgb.double())
        d = (out64 - out32).abs()
        print(f"trial {trial}: fp32 against fp64 max|diff| {d.max().item():.6e}, share over "
              f"1/255 {(d > 1 / 255).double().mean().item():.6e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
