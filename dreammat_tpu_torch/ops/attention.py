"""Flash attention for the diffusion UNet and ControlNet, forward and backward.

Counterpart of ``dreammat_tpu/ops/attention.py``. On CUDA tensors every call
launches hand-written kernels: the forward ``csrc/flash_attn_fwd.cu``
(kernel A, which replaces the Pallas ``_fwd_kernel``) and, through autograd,
the backward ``csrc/flash_attn_bwd.cu`` (kernel C for dq, which replaces
``_bwd_dq_kernel``; kernel D for dk and dv, which replaces
``_bwd_dkv_kernel``). On CPU tensors ``attention`` runs ``attention_plain``,
the plain PyTorch version, and autograd differentiates that. There is no
dispatch gate by length: every D=64 bf16 attention of the UNet and
ControlNet, self and cross, goes through the kernels on the card.

Layout is the JAX package's ``[B, N, H, D]``, read and written through
strides. The forward saves q, k, v, O and the per-row log-sum-exp L
``[B*H, N]`` f32; the backward computes D = rowsum(dO * O) in PyTorch (the
JAX package computes it outside its kernels too) and launches kernel C when
q needs a gradient and kernel D when k or v does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from dreammat_tpu_torch.ops import kernels

_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_void_p]
)
_DQ_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 15
    + [ctypes.c_float, ctypes.c_void_p]
)
_DKV_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 18
    + [ctypes.c_float, ctypes.c_void_p]
)


_SCALE = 1.0 / math.sqrt(64)  # the kernels are built for D = 64


def _stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index`` (also
    inside a CUDA-graph capture, which runs on a side stream)."""
    return torch._C._cuda_getCurrentRawStream(index)


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


def attention_backward_plain(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in fp32 by the FlashAttention-2 equations: p = exp(scale
    q.k - L), D = rowsum(dO * O), dv = p^T dO, ds = p (dO v^T - D),
    dq = scale ds k, dk = scale ds^T q. q/o/do [B,N,H,D], k/v [B,M,H,D],
    lse [B*H, N]."""
    return _plain_bwd(q, k, v, do, lse, _delta(o, do))


def _delta(o, do) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, as [B*H, N]."""
    B, N, H, _ = o.shape
    d = (do.float() * o.float()).sum(-1)  # [B,N,H]
    return d.permute(0, 2, 1).reshape(B * H, N).contiguous()


def _plain_bwd(q, k, v, do, lse, delta):
    B, N, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    p = torch.exp(s - lse.reshape(B, H, N, 1))
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - delta.reshape(B, H, N, 1))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq, dk, dv


def _layout_ok(t: torch.Tensor) -> bool:
    """Unit-stride head dim, 8-element (16-byte) strides and a 16-byte-aligned
    base: what the kernels' TMA tensor maps and vector stores need."""
    sb, sn, sh, sd = t.stride()
    return sd == 1 and not (sb % 8 or sn % 8 or sh % 8) and t.data_ptr() % 16 == 0


def _check_cuda_inputs(q, k, v) -> None:
    """Every check that guards the kernels' correctness, in one pass."""
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd expects q/k/v of rank 4 [B,N,H,D]")
    B, N, H, D = qs
    if ks != v.shape or ks[0] != B or ks[2] != H or ks[3] != D:
        raise ValueError(f"k/v shape {tuple(ks)} does not match q {tuple(qs)}")
    if D != 64:
        raise ValueError(f"the CUDA attention kernel is built for D=64 only, got D={D}")
    if N < 1 or ks[1] < 1:
        raise ValueError("empty sequence")
    bf16 = torch.bfloat16
    if q.dtype != bf16 or k.dtype != bf16 or v.dtype != bf16:
        raise TypeError(f"q, k and v must be bfloat16 on CUDA, got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("q, k and v must be on the same device")
    if not (_layout_ok(q) and _layout_ok(k) and _layout_ok(v)):
        raise ValueError("q, k and v must have a unit-stride head dim, 8-element-aligned "
                         "strides and a 16-byte-aligned base pointer")
    if B * H > 65535:
        raise ValueError("B*H exceeds the grid limit of 65535")


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _launch_error(what: str, rc: int) -> RuntimeError:
    if rc < 0:
        return RuntimeError(f"{what}: TMA tensor-map encoding failed (CUresult {-rc}; "
                            "-1000: libcuda has no cuTensorMapEncodeTiled)")
    return RuntimeError(f"{what} kernel launch failed (cudaError {rc})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out [B,N,H,D], lse [B*H,N] f32). CUDA tensors launch kernel A,
    CPU tensors run the plain version."""
    if not q.is_cuda:
        return _plain_with_lse(q, k, v)
    _check_cuda_inputs(q, k, v)
    fn = kernels.function("flash_attn_fwd", "flash_attn_fwd_bf16_d64", _ARGTYPES)
    B, N, H, _ = q.shape
    out = torch.empty_like(q)  # q's strides where q is dense, else contiguous
    lse = torch.empty((B * H, N), dtype=torch.float32, device=q.device)
    qs, ks, vs, os = q.stride(), k.stride(), v.stride(), out.stride()
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, N, k.shape[1], H, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        os[0], os[1], os[2], _SCALE, _stream(q.get_device()),
    )
    if rc != 0:
        raise _launch_error("flash_attn_fwd", rc)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _check_bwd_inputs(q, k, v, do, lse, delta) -> None:
    _check_cuda_inputs(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dO shape {tuple(do.shape)} does not match q {tuple(q.shape)}")
    if do.dtype != torch.bfloat16:
        raise TypeError(f"dO must be bfloat16 on CUDA, got {do.dtype}")
    if do.device != q.device or not _layout_ok(do):
        raise ValueError(
            "dO must be on q's device, with a unit-stride head dim, 8-element-aligned "
            "strides and a 16-byte-aligned base pointer"
        )
    B, N, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, N) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [B*H, N] = [{B * H}, {N}]")
        if t.device != q.device:
            raise ValueError(f"{name} must be on q's device")


def flash_attention_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq [B,N,H,D] in q's dtype. CUDA tensors launch kernel C, CPU tensors
    run the plain version."""
    if not q.is_cuda:
        return _plain_bwd(q, k, v, do, lse, delta)[0].to(q.dtype)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    fn = kernels.function("flash_attn_bwd", "flash_attn_bwd_dq_bf16_d64", _DQ_ARGTYPES)
    B, N, H, _ = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, N, k.shape[1], H,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dq),
        _SCALE, _stream(q.get_device()),
    )
    if rc != 0:
        raise _launch_error("flash_attn_bwd dq", rc)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,M,H,D] in k's and v's dtype. CUDA tensors launch kernel D,
    CPU tensors run the plain version."""
    if not q.is_cuda:
        _, dk, dv = _plain_bwd(q, k, v, do, lse, delta)
        return dk.to(k.dtype), dv.to(v.dtype)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    fn = kernels.function("flash_attn_bwd", "flash_attn_bwd_dkv_bf16_d64", _DKV_ARGTYPES)
    B, N, H, _ = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, k.shape[1], H,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dk), *_strides(dv),
        _SCALE, _stream(q.get_device()),
    )
    if rc != 0:
        raise _launch_error("flash_attn_bwd dk/dv", rc)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of attention at (q, k, v) with output o, log-sum-exp lse
    and output gradient do; a gradient that is not needed comes back None
    and its kernel is not launched."""
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta) if need_dq else None
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta) if need_dkv else (None, None)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad
        if not _layout_ok(grad_out):
            grad_out = grad_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out, need_dq=need_q,
                                         need_dkv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D]. Non-causal, no mask."""
    if not q.is_cuda:
        return attention_plain(q, k, v)
    return _FlashAttention.apply(q, k, v)
