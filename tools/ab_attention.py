"""Time the attention kernels A (forward), C (dq) and D (dk/dv) of one tree
of the port, for an A/B of two versions in one call on the card.

    python3 tools/ab_attention.py --label change [--kernels ACD]
    python3 tools/ab_attention.py --root <unpacked older tree> --label parent

``--root`` puts that tree's ``dreammat_tpu_torch`` first on the path, so
its kernels are built from its own sources (into its own ``build/``); the
timing helpers come from this repository's ``chip_smoke.py``. Run the trees
in turns (parent, change, change, parent) and compare within the call. For
each shape it prints one JSON line: kernel time by CUDA events over many
launches (``ms``), device time from a CUDA-graph replay (``graph_ms``), host
microseconds per launch without a synchronize (``host_us``), and the same
for SDPA (for C: its autograd backward with respect to q; for D, with
respect to k and v; graph times of a forward and backward less the
forward). C runs at the two long shapes and at every ControlNet-training
shape (batch 32). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FWD_SHAPES = [(3, 4096, 4096, 5), (3, 1024, 1024, 10), (3, 64, 64, 20), (3, 4096, 77, 5)]
DKV_SHAPES = [(32, 1024, 1024, 5), (3, 4096, 4096, 5)]
# the two long shapes, then the rest of the ControlNet-training shapes at batch 32
DQ_SHAPES = DKV_SHAPES + [(32, 256, 256, 10), (32, 64, 64, 20), (32, 16, 16, 20),
                          (32, 1024, 77, 5), (32, 256, 77, 10), (32, 64, 77, 20),
                          (32, 16, 77, 20)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="tree whose dreammat_tpu_torch is timed")
    ap.add_argument("--label", required=True)
    ap.add_argument("--kernels", default="ACD", help="which of A, C, D to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch.nn.functional as F

    from dreammat_tpu_torch.ops import attention as attn

    if not attn.__file__.startswith(os.path.abspath(args.root)):
        raise RuntimeError(f"imported {attn.__file__}, not from {args.root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    for B, N, M, H in FWD_SHAPES if "A" in args.kernels else []:
        q, k, v = rand(B, N, H, 64), rand(B, M, H, 64), rand(B, M, H, 64)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kern = lambda: attn.flash_attention_fwd(q, k, v)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        row = dict(label=args.label, kernel="A", B=B, N=N, M=M, H=H,
                   ms=cs.cuda_ms(kern, 20), graph_ms=cs.graph_ms(kern), host_us=cs.host_us(kern),
                   sdpa_ms=cs.cuda_ms(sdpa, 20), sdpa_graph_ms=cs.graph_ms(sdpa),
                   sdpa_host_us=cs.host_us(sdpa), card=card)
        if N == M == 64 and args.root == HERE:
            # where the host time of one launch goes: the checks, the two
            # allocations, and the C entry point (tensor maps, launch) with ctypes
            fn = attn.kernels.function("flash_attn_fwd", "flash_attn_fwd_bf16_d64", attn._ARGTYPES)
            out, lse = kern()
            qs, ks, vs = q.stride(), k.stride(), v.stride()
            cargs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    B, N, M, H, *qs[:3], *ks[:3], *vs[:3], *out.stride()[:3],
                    attn._SCALE, attn._stream(q.get_device()))
            row["host_us_parts"] = {
                "checks": cs.host_us(lambda: attn._check_cuda_inputs(q, k, v), 2000),
                "two_empty": cs.host_us(lambda: (
                    torch.empty((B, N, H, 64), dtype=torch.bfloat16, device="cuda"),
                    torch.empty((B * H, N), dtype=torch.float32, device="cuda")), 2000),
                "c_entry": cs.host_us(lambda: fn(*cargs)),
            }
        print(json.dumps(row), flush=True)

    bwd = [("C", (True, False, False), DQ_SHAPES, attn.flash_attention_bwd_dq),
           ("D", (False, True, True), DKV_SHAPES, attn.flash_attention_bwd_dkv)]
    for name, need, shapes, fn in bwd:
        if name not in args.kernels:
            continue
        for B, N, M, H in shapes:
            q, k, v = rand(B, N, H, 64), rand(B, M, H, 64), rand(B, M, H, 64)
            do = rand(B, N, H, 64)
            out, lse = attn.flash_attention_fwd(q, k, v)
            delta = attn._delta(out, do)
            kern = lambda: fn(q, k, v, do, lse, delta)
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            xs = [x.detach().requires_grad_(n) for x, n in zip((qt, kt, vt), need)]
            o_lib = F.scaled_dot_product_attention(*xs)
            wrt = [x for x in xs if x.requires_grad]
            sdpa = lambda: torch.autograd.grad(o_lib, wrt, dot, retain_graph=True)
            row = dict(label=args.label, kernel=name, B=B, N=N, M=M, H=H,
                       ms=cs.cuda_ms(kern, 20), graph_ms=cs.graph_ms(kern),
                       host_us=cs.host_us(kern), sdpa_ms=cs.cuda_ms(sdpa, 20),
                       sdpa_host_us=cs.host_us(sdpa),
                       sdpa_graph_ms=cs.sdpa_grad_graph_ms(qt, kt, vt, dot, need), card=card)
            del o_lib
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
