"""Port parity: dreammat_tpu_torch.ops.attention against the JAX flash kernel.

The same numpy inputs go through the JAX Pallas forward (interpret mode on
the CPU) and its fp32 reference, and through the port's plain version
(what the port runs on a CPU tensor). The CUDA kernel itself is held
against the plain version in the ``cuda``-marked tests, which skip without
a GPU. The machine with the card has no JAX, so JAX is imported by the
tests that use it; there run the ``cuda`` tests alone, without the JAX
conftest: ``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_SHAPES, TRAIN_ATTN_SHAPES
from dreammat_tpu_torch.ops import attention as tattn
from dreammat_tpu_torch.ops import kernels
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

SHAPES = [
    (1, 256, 256, 2, 64),
    (2, 300, 300, 4, 64),
    (1, 256, 77, 4, 64),
    (1, 64, 64, 1, 32),
    (1, 200, 200, 2, 64),
]


def _inputs(B, N, M, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(B, N, H, D)).astype(np.float32),
            rng.normal(size=(B, M, H, D)).astype(np.float32),
            rng.normal(size=(B, M, H, D)).astype(np.float32))


@pytest.fixture
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from dreammat_tpu.ops import attention as jattn

    return jnp, jattn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_flash_and_reference(shape, jax_ref):
    jnp, jattn = jax_ref
    q, k, v = _inputs(*shape)
    ref = np.asarray(jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    flash = np.asarray(jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             block_q=128, block_k=128, interpret=True))
    got = tattn.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v)).numpy()
    assert np.abs(got - ref).max() <= 1e-4
    assert np.abs(got - flash).max() <= 1e-4


def test_cpu_wrapper_runs_plain_with_lse():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 40, 77, 3, 64, seed=1))
    before = tattn.flash_attention_fwd.launches
    out, lse = tattn.flash_attention_fwd(q, k, v)
    assert tattn.flash_attention_fwd.launches == before  # no kernel on the CPU
    assert torch.equal(out, tattn.attention_plain(q, k, v))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / 8.0
    assert lse.shape == (6, 40)
    assert torch.allclose(lse, torch.logsumexp(s, -1).reshape(6, 40), atol=1e-5)


@pytest.mark.parametrize("bad", ["d32", "fp32", "kv_heads", "stride"])
def test_cuda_input_checks(bad):
    q = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    v = k.clone()
    if bad == "d32":
        q, k, v = q[..., :32], k[..., :32].contiguous(), v[..., :32].contiguous()
    elif bad == "fp32":
        q = q.float()
    elif bad == "kv_heads":
        k = torch.zeros(1, 8, 3, 64, dtype=torch.bfloat16)
        v = k.clone()
    else:
        q = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        tattn._check_cuda_inputs(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1024, 1024, 10, 64), (3, 4096, 77, 5, 64),
                                   (2, 300, 200, 4, 64)])
def test_kernel_matches_plain_on_cuda(cuda, shape):
    B, N, M, H, D = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, n, H, D, generator=g, device=cuda).to(torch.bfloat16)
               for n in (N, M, M))
    out, lse = tattn.flash_attention_fwd(q, k, v)
    ref, ref_lse = tattn._plain_with_lse(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("nmh", ATTN_SHAPES)
def test_kernel_matches_plain_at_the_perp_neg_batch_on_cuda(cuda, nmh):
    # Perp-Neg runs the UNet and the ControlNet on five replicas: B = 5
    N, M, H = nmh
    g = torch.Generator(device=cuda).manual_seed(5 * N + M)
    q, k, v = (torch.randn(5, n, H, 64, generator=g, device=cuda).to(torch.bfloat16)
               for n in (N, M, M))
    _check_fwd(q, k, v)


BWD_SHAPES = [SHAPES[0], SHAPES[1], SHAPES[2]]  # incl. ragged N=M=300 and cross M=77


@pytest.fixture(scope="module")
def jax_bwd_refs():
    """Per BWD_SHAPES entry: the inputs, the output gradient, the JAX flash
    forward's O and L, its flash backward (interpret mode) and jax.vjp of
    reference_attention."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from dreammat_tpu.ops import attention as jattn

    refs = {}
    for shape in BWD_SHAPES:
        q, k, v = _inputs(*shape, seed=2)
        g = np.random.RandomState(3).normal(size=q.shape).astype(np.float32)
        jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
        o, lse = jattn._flash_forward(jq, jk, jv, block_q=128, block_k=128, interpret=True)
        flash = jattn._flash_backward(jq, jk, jv, o, lse, jg, block_q=128, block_k=128,
                                      interpret=True)
        vjp = jax.vjp(jattn.reference_attention, jq, jk, jv)[1](jg)
        B, N, H = q.shape[0], q.shape[1], q.shape[2]
        refs[shape] = dict(
            q=q, k=k, v=v, g=g, o=np.array(o), lse=np.array(lse)[:, :N, 0].reshape(B * H, N),
            flash=[np.asarray(x) for x in flash], ref=[np.asarray(x) for x in vjp])
    return refs


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_plain_backward_matches_jax(shape, jax_bwd_refs):
    r = jax_bwd_refs[shape]
    t = {n: torch.from_numpy(r[n]) for n in ("q", "k", "v", "o", "lse", "g")}
    got = tattn.attention_backward_plain(t["q"], t["k"], t["v"], t["o"], t["lse"], t["g"])
    for name, a, fl, ref in zip("qkv", got, r["flash"], r["ref"]):
        assert np.abs(a.numpy() - fl).max() <= 1e-4, f"d{name} vs the JAX flash backward"
        assert np.abs(a.numpy() - ref).max() <= 1e-4, f"d{name} vs jax.vjp of the reference"


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_cpu_autograd_matches_jax(shape, jax_bwd_refs):
    r = jax_bwd_refs[shape]
    q, k, v = (torch.from_numpy(r[n]).requires_grad_(True) for n in "qkv")
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    tattn.attention(q, k, v).backward(torch.from_numpy(r["g"]))
    assert (tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == before  # no kernel on the CPU
    for name, x, fl, ref in zip("qkv", (q, k, v), r["flash"], r["ref"]):
        assert np.abs(x.grad.numpy() - ref).max() <= 1e-4, f"d{name} vs jax.vjp of the reference"
        assert np.abs(x.grad.numpy() - fl).max() <= 1e-4, f"d{name} vs the JAX flash backward"


def test_cpu_backward_wrappers_run_plain():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 40, 77, 3, 64, seed=4))
    out, lse = tattn.flash_attention_fwd(q, k, v)
    do = torch.from_numpy(np.random.RandomState(5).normal(size=q.shape).astype(np.float32))
    dq, dk, dv = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    ref = tattn.attention_backward_plain(q, k, v, out, lse, do)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
    assert tattn.flash_attention_bwd(q, k, v, out, lse, do, need_dq=False)[0] is None
    assert tattn.flash_attention_bwd(q, k, v, out, lse, do, need_dkv=False)[1:] == (None, None)


def _close_bf16(got, ref):
    """bf16 kernel against the fp32 plain version: cosine >= 0.999 and max
    error <= 2e-2 * max|ref| (ds and p are rounded to bf16 inside the kernels)."""
    g, r = got.float().flatten(), ref.float().flatten()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    err = (g - r).abs().max().item()
    return cos >= 0.999 and err <= 2e-2 * r.abs().max().item(), (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 1024, 5, 64), (8, 16, 77, 20, 64),
                                   (2, 300, 200, 4, 64), (3, 200, 300, 2, 64)])
def test_backward_kernels_match_plain_on_cuda(cuda, shape):
    B, N, M, H, D = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    # q and dO as strided views of packed tensors, as the UNet's projections give them
    q = torch.randn(B, N, 2, H, D, generator=g, device=cuda).to(torch.bfloat16)[:, :, 1]
    k, v = (torch.randn(B, M, H, D, generator=g, device=cuda).to(torch.bfloat16) for _ in "kv")
    do = torch.randn(B, N, 2, H, D, generator=g, device=cuda).to(torch.bfloat16)[:, :, 0]
    out, lse = tattn.flash_attention_fwd(q, k, v)
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    got = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    assert (tattn.flash_attention_bwd_dq.launches - before[0],
            tattn.flash_attention_bwd_dkv.launches - before[1]) == (1, 1)
    ref = tattn.attention_backward_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, ref):
        ok, (cos, err) = _close_bf16(a, b)
        assert ok, f"d{name}: cosine {cos:.6f}, max |err| {err:.3e}"


@pytest.mark.cuda
def test_autograd_launches_only_the_needed_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, n, 4, 64, generator=g, device=cuda).to(torch.bfloat16)
               for n in (256, 77, 77))
    dout = torch.randn(2, 256, 4, 64, generator=g, device=cuda).to(torch.bfloat16)
    for needs, want in (("q", (1, 0)), ("kv", (0, 1)), ("qkv", (1, 1))):
        xs = [x.clone().requires_grad_(n in needs) for n, x in zip("qkv", (q, k, v))]
        before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
        tattn.attention(*xs).backward(dout)
        assert (tattn.flash_attention_bwd_dq.launches - before[0],
                tattn.flash_attention_bwd_dkv.launches - before[1]) == want
        out, lse = tattn.flash_attention_fwd(q, k, v)
        ref = tattn.attention_backward_plain(q, k, v, out, lse, dout)
        for x, r in zip(xs, ref):
            if x.requires_grad:
                ok, (cos, err) = _close_bf16(x.grad, r)
                assert ok, f"{needs}: cosine {cos:.6f}, max |err| {err:.3e}"
            else:
                assert x.grad is None


@pytest.mark.parametrize("bad", ["do_shape", "do_fp32", "do_stride", "lse_shape", "delta_fp16",
                                 "lse_strided"])
def test_cuda_backward_input_checks(bad):
    q = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    v, do = k.clone(), q.clone()
    lse, delta = torch.zeros(2, 16), torch.zeros(2, 16)
    if bad == "do_shape":
        do = do[:, :8]
    elif bad == "do_fp32":
        do = do.float()
    elif bad == "do_stride":
        do = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)[..., ::2]
    elif bad == "lse_shape":
        lse = torch.zeros(2, 8)
    elif bad == "delta_fp16":
        delta = delta.half()
    else:
        lse = torch.zeros(16, 2).t()
    tattn._check_bwd_inputs(q, k, v, q.clone(), torch.zeros(2, 16), torch.zeros(2, 16))
    with pytest.raises((ValueError, TypeError)):
        tattn._check_bwd_inputs(q, k, v, do, lse, delta)


def test_layout_check_takes_strided_views_of_fused_projections():
    # q, k, v sliced out of one [B, N, 3, H, D] tensor, as a fused projection gives them
    qkv = torch.zeros(2, 16, 3, 4, 64, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    tattn._check_cuda_inputs(q, k, v)
    with pytest.raises(ValueError):  # 16-byte strides are what the tensor maps need
        tattn._check_cuda_inputs(torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64], k, v)


def test_launch_errors_name_their_cause():
    assert "cudaError 700" in str(tattn._launch_error("flash_attn_fwd", 700))
    msg = str(tattn._launch_error("flash_attn_fwd", -1))
    assert "tensor-map" in msg and "CUresult 1" in msg


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_sm90_kernelE14CUtensorMap_st
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 UTMALDG.4D [UR8], [UR4] ;          /* 0x00000008040075b4 */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0030*/              @UP0 BRA 0x30 ;
\t\tFunction : _ZN12_GLOBAL__N_13dqk24flash_bwd_dq_sm90_kernelE14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiixxxf
        /*0000*/                   SYNCS.EXCH.64 URZ, [UR4], UR6 ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR12], R88 ;
\t\tFunction : _ZN12_GLOBAL__N_17ampere_dq_kernelILi64EEEvPK13__nv_bfloat16
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
"""


def test_sass_opcodes_per_function():
    ops = kernels.sass_opcodes(_SASS)
    assert len(ops) == 3
    fwd, dq, old = (next(n for n in ops if key in n)
                    for key in ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "ampere"))
    assert {"HGMMA", "UTMALDG", "LDC", "BRA"} == ops[fwd]
    assert {"SYNCS", "HGMMA"} == ops[dq]
    assert {"LDSM", "HMMA"} == ops[old]


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// kernel")
    (tmp_path / "common.cuh").write_text("// v1")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    monkeypatch.setitem(kernels.SOURCES, "probe", "k.cu")
    before = kernels._lib_path("probe")
    (tmp_path / "common.cuh").write_text("// v2")
    assert kernels._lib_path("probe") != before


def _check_fwd(q, k, v):
    out, lse = tattn.flash_attention_fwd(q, k, v)
    ref, ref_lse = tattn._plain_with_lse(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, (err.max().item(),
                                                                     err.mean().item())
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def _check_bwd(q, k, v, do):
    out, lse = tattn.flash_attention_fwd(q, k, v)
    got = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    ref = tattn.attention_backward_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, ref):
        ok, (cos, err) = _close_bf16(a, b)
        assert ok, f"d{name}: cosine {cos:.6f}, max |err| {err:.3e}"


# every attention shape of both main paths (N, M, H), at a small batch
PATH_SHAPES = sorted(set(ATTN_SHAPES) | set(TRAIN_ATTN_SHAPES))


@pytest.mark.cuda
@pytest.mark.parametrize("nmh", PATH_SHAPES)
def test_kernels_at_every_path_shape_on_cuda(cuda, nmh):
    N, M, H = nmh
    g = torch.Generator(device=cuda).manual_seed(N + M + H)
    q, k, v, do = (torch.randn(2, n, H, 64, generator=g, device=cuda).to(torch.bfloat16)
                   for n in (N, M, M, N))
    _check_fwd(q, k, v)
    _check_bwd(q, k, v, do)


@pytest.mark.cuda
@pytest.mark.parametrize("nm", [(1024, 1024), (256, 77), (64, 64), (16, 77), (300, 200)])
def test_kernels_on_fused_projection_views_on_cuda(cuda, nm):
    # q, k, v (and dO) sliced out of one [B, N, 3, H, D] tensor: non-contiguous strides
    N, M = nm
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(2, max(N, M), 3, 5, 64, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :N, 0], qkv[:, :M, 1], qkv[:, :M, 2]
    do = torch.randn(2, N, 2, 5, 64, generator=g, device=cuda).to(torch.bfloat16)[:, :, 1]
    _check_fwd(q, k, v)
    _check_bwd(q, k, v, do)


@pytest.mark.cuda
@pytest.mark.parametrize("nm", [(129, 65), (65, 2), (1, 130), (191, 1000), (4097, 77)])
def test_kernels_at_ragged_lengths_on_cuda(cuda, nm):
    # N and M off the 64- and 128-row tiles: zero-filled keys past M get
    # p = 0, rows past N are not stored, a block's second consumer may idle
    # (M >= 2: with one key, p = 1 and dq is 0 up to rounding)
    N, M = nm
    g = torch.Generator(device=cuda).manual_seed(N * 7 + M)
    q, k, v, do = (torch.randn(2, n, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
                   for n in (N, M, M, N))
    _check_fwd(q, k, v)
    _check_bwd(q, k, v, do)


@pytest.mark.cuda
def test_kernels_at_640_batch_heads_on_cuda(cuda):
    # the training mid block: B = 32, H = 20, 16 tokens, B*H = 640 on the grid's y
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do = (torch.randn(32, n, 20, 64, generator=g, device=cuda).to(torch.bfloat16)
                   for n in (16, 77, 77, 16))
    _check_fwd(q, k, v)
    _check_bwd(q, k, v, do)
    _check_fwd(q, q, q)
