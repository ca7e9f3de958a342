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

from dreammat_tpu_torch.ops import attention as tattn

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
def test_kernel_backward_is_not_ported(cuda):
    q = torch.randn(1, 64, 1, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    out = tattn.attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError):
        out.sum().backward()
