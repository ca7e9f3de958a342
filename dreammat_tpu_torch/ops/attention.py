"""Flash attention for the diffusion UNet and ControlNet.

Counterpart of ``dreammat_tpu/ops/attention.py``. On a CUDA tensor every call
launches the hand-written forward kernel ``csrc/flash_attn_fwd.cu`` (kernel
A, which replaces the Pallas ``_fwd_kernel``); on a CPU tensor it runs
``attention_plain``, the plain PyTorch version of the same function. There is
no dispatch gate by length: every D=64 bf16 attention of the UNet and
ControlNet, self and cross, goes through the kernel on the card.

Layout is the JAX package's ``[B, N, H, D]``. The kernel reads and writes it
through strides and also returns the per-row log-sum-exp ``[B*H, N]`` f32
that the backward kernels of a later slice will consume. The backward is not
ported yet: differentiating through the CUDA path raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_void_p]
)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in fp32, returned in q's dtype.
    q [B,N,H,D], k/v [B,M,H,D]."""
    return _plain_with_lse(q, k, v)[0]


def _plain_with_lse(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    B, N, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)  # [B,H,N]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)
    return out, lse.reshape(B * H, N)


def _check_cuda_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd expects q/k/v of rank 4 [B,N,H,D]")
    B, N, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if D != 64:
        raise ValueError(f"the CUDA attention kernel is built for D=64 only, got D={D}")
    if N < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("q, k and v must be on the same device")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a unit-stride head dim, 8-element-aligned strides "
                "and a 16-byte-aligned base pointer"
            )
    if B * H > 65535:
        raise ValueError("B*H exceeds the grid limit of 65535")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out [B,N,H,D], lse [B*H,N] f32). CUDA tensors launch kernel A,
    CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return _plain_with_lse(q, k, v)
    _check_cuda_inputs(q, k, v)
    from dreammat_tpu_torch.ops import kernels

    fn = kernels.function("flash_attn_fwd", "flash_attn_fwd_bf16_d64", _ARGTYPES)
    B, N, H, D = q.shape
    M = k.shape[1]
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, N, M, H,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        1.0 / math.sqrt(D), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed (cudaError {rc})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, _ = flash_attention_fwd(q, k, v)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "slice 2: the flash-attention backward kernels (_bwd_dq_kernel, "
            "_bwd_dkv_kernel) are not ported yet"
        )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D]. Non-causal, no mask."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _FlashAttention.apply(q, k, v)
