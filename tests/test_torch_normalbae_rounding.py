"""NormalBae's BatchNorm inference in the JAX package's form.

The JAX package's ``_bn`` subtracts the mean first, (x - mean) * rsqrt(var +
eps) * scale + bias. PyTorch's CPU inference of ``nn.BatchNorm2d`` folds it
into x * a + (bias - mean * a): on a channel whose mean is large beside its
spread (a flat region of a render, the statistics taken from that render
as ``chip_smoke.batchnorm_from_input`` takes them) the large x * a and its
rounding survive in a small result. The port's ``CenteredBatchNorm2d``
computes the JAX package's form: on such a channel it stays within a few
units in the last place of fp64, the folded form hundreds of times further
off. Training (the statistics' update) and the state dict stay PyTorch's,
and every BatchNorm of NormalBae is the centred one.
"""

import numpy as np
import pytest
import torch

from dreammat_tpu_torch.models import detectors
from torch_threads import one_thread  # noqa: F401


def _flat_channels(seed=0):
    """[1,4,32,32] fp32: means 5, -3, 0.5, 0 and spreads 1e-3, 1e-4, 1, 1e-2."""
    rng = np.random.RandomState(seed)
    mean = np.array([5.0, -3.0, 0.5, 0.0])[None, :, None, None]
    spread = np.array([1e-3, 1e-4, 1.0, 1e-2])[None, :, None, None]
    return torch.from_numpy((mean + spread * rng.randn(1, 4, 32, 32)).astype(np.float32))


def _with_stats(cls, x, eps):
    bn = cls(4, eps=eps, momentum=None)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, 0.5, 2.0, 1.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.0, 0.3]))
        bn.train()
        bn(x)
    return bn.eval()


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_centred_inference_keeps_a_flat_channel(eps):
    x = _flat_channels()
    bn = _with_stats(detectors.CenteredBatchNorm2d, x, eps)
    sh = (1, -1, 1, 1)
    f64 = lambda t: t.detach().double().view(sh)
    with torch.no_grad():
        ref = ((x.double() - f64(bn.running_mean)) * torch.rsqrt(f64(bn.running_var) + eps)
               * f64(bn.weight) + f64(bn.bias))
        centred = bn(x).double()
        folded = torch.nn.BatchNorm2d.forward(bn, x).double()
    err_c = (centred - ref).abs().amax(dim=(0, 2, 3))
    err_f = (folded - ref).abs().amax(dim=(0, 2, 3))
    ulp = ref.abs().amax(dim=(0, 2, 3)) * 2.0 ** -23
    print("centred", err_c.tolist(), "folded", err_f.tolist())
    assert bool((err_c <= 4 * ulp).all()), (err_c, ulp)
    # the flat channels (mean 5 and -3): the folded form loses digits
    assert bool((err_f[:2] >= 100 * err_c[:2]).all()), (err_f, err_c)


def test_training_and_state_dict_are_pytorchs():
    x = _flat_channels(1)
    ours = _with_stats(detectors.CenteredBatchNorm2d, x, 1e-3)
    theirs = _with_stats(torch.nn.BatchNorm2d, x, 1e-3)
    assert ours.state_dict().keys() == theirs.state_dict().keys()
    for k, v in theirs.state_dict().items():
        assert torch.equal(ours.state_dict()[k], v), k
    ours.train()
    theirs.train()
    with torch.no_grad():
        assert torch.equal(ours(x), theirs(x))
    fresh = detectors.CenteredBatchNorm2d(4, eps=1e-3)
    fresh.load_state_dict(theirs.state_dict(), strict=True)


@pytest.mark.parametrize("architecture", ["GN", "BN"])
def test_normalbae_batchnorms_are_centred(architecture):
    model = detectors.NormalBae(architecture, detect_resolution=32)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(isinstance(m, detectors.CenteredBatchNorm2d) for m in bns)
    if architecture == "BN":  # the decoder's keep PyTorch's default eps, as the JAX _bn
        assert any(m.eps == 1e-5 for m in bns) and any(m.eps == 1e-3 for m in bns)
