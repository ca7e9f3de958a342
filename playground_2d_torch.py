"""2D guidance playground of the PyTorch/CUDA port: SDS on a 2D image, no 3D.

The flags of ``playground_2d.py``, plus ``--device`` (default ``cuda``):
optimize an RGB image directly with the DreamMat guidance (no ControlNet,
``uncond_scale`` -1, so classifier-free guidance of scale 1 anchored at
the text prediction) and Adam, writing ``step*.png`` every 50 steps and
``final.png``. The image starts gray, perturbed by under half an 8-bit
level (``playground_2d.py`` starts at the exact gray).

    python playground_2d_torch.py --prompt "a red apple" --steps 200 \
        --size 64 --model-size tiny                 # random weights
    python playground_2d_torch.py --prompt "..." --model-size sd21 --cache-dir model
    python playground_2d_torch.py --prompt "..." --device cpu   # without a GPU
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--model-size", default="tiny", choices=["tiny", "sd21"])
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--out", default="outputs/playground2d")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import torch

    import dreammat_tpu_torch
    import dreammat_tpu_torch.models  # noqa: F401 (registry)
    from dreammat_tpu_torch.utils import saving
    from dreammat_tpu_torch.utils.hw import resolve_device
    from dreammat_tpu_torch.utils.rng import TorchDraws

    device = resolve_device(args.device)
    guidance = dreammat_tpu_torch.find("stable-diffusion-dreammat-guidance")({
        "model_size": args.model_size, "width": args.size, "height": args.size,
        "half_precision_weights": args.model_size != "tiny", "cache_dir": args.cache_dir,
        "controlnet_path": None, "use_controlnet": False, "cond_scale": 1.0,
        "uncond_scale": -1.0, "null_scale": 0.0, "noise_scale": 0.0,
        "view_dependent_prompting": False,
    }, device=device)
    guidance.init_params(torch.Generator(device=device).manual_seed(args.seed))
    prompt_utils = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")({
        "prompt": args.prompt, "negative_prompt": args.negative_prompt,
        "model_size": args.model_size,
        "pretrained_model_cache_dir": args.cache_dir or "/nonexistent",
    }, device=device)()

    # gray, moved by under half an 8-bit level: at the exact gray the VAE's
    # input is 0, and with random weights (zero biases) every GroupNorm of
    # the SD2.1 encoder then sees zero variance and the image's gradient
    # overflows (NaN from the second step; the same in the JAX package)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    rgb = (0.5 + (torch.rand((1, 3, args.size, args.size), generator=gen, device=device) - 0.5)
           / 255.0).requires_grad_(True)
    opt = torch.optim.Adam([rgb], lr=args.lr)
    draws = TorchDraws(args.seed + 1, device)
    zeros, ones = torch.zeros(1, device=device), torch.ones(1, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    os.makedirs(args.out, exist_ok=True)
    losses, seconds = [], []

    def image():
        return torch.clamp(rgb.detach()[0], 0, 1).permute(1, 2, 0).float().cpu().numpy()

    for i in range(args.steps):
        t0 = time.time()
        opt.zero_grad(set_to_none=True)
        out = guidance(torch.clamp(rgb, 0, 1), prompt_utils, zeros, zeros, ones, None,
                       step=i, draws=draws)
        out["loss_sds"].backward()
        opt.step()
        sync()
        seconds.append(time.time() - t0)
        losses.append(float(out["loss_sds"].detach()))
        if (i + 1) % 50 == 0 or i == 0:
            dreammat_tpu_torch.info("step %d loss=%.4f (%.3f s/step)", i + 1, losses[-1],
                                    seconds[-1])
            saving.save_image(os.path.join(args.out, f"step{i + 1:05d}.png"), image())
    final = os.path.join(args.out, "final.png")
    saving.save_image(final, image())
    dreammat_tpu_torch.info("wrote %s", final)
    return {"final": final, "losses": losses, "step_seconds": seconds, "guidance": guidance}


if __name__ == "__main__":
    main()
