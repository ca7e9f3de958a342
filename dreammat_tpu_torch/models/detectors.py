"""Condition-map detectors of the public-ControlNet guidance: HED and NormalBae.

Counterpart of ``dreammat_tpu/models/detectors.py``:

- **HED** (``ControlNetHED``, the ``ControlNetHED_Apache2`` network of
  lllyasviel/Annotators): five VGG stages ``(3,64,2) (64,128,2)
  (128,256,3) (256,512,3) (512,512,3)`` on ``x*255 - norm`` with a 2x2
  max-pool between stages and a 1x1 projection to one side map per stage;
  ``detect`` upsamples the side maps (half-pixel bilinear), averages them
  and takes a sigmoid. The scribble variant then runs ``scribble_nms``: a
  zero-padded separable gaussian blur of radius round(3 sigma) (cv2 would
  reflect at the border) and a 4-direction max suppression whose
  neighbours wrap around the border (``torch.roll``, as the JAX package's
  ``jnp.roll``; cv2 does not wrap), then a threshold.
- **NormalBae** (the NNET estimator behind ``scannet.pt``): a
  ``tf_efficientnet_b5_ap`` encoder (stem 48, seven MBConv stages, head
  2048; TF "SAME" padding, which puts the extra row and column of a
  stride-2 convolution at the bottom and right; BatchNorm eps 1e-3) whose
  skips are stages 0, 1, 2 and 4 and the conv head before its bn2; a
  decoder of a 1x1 bottleneck and four up-blocks (bilinear with
  align_corners, weight-standardized 3x3 convolutions, GroupNorm(8) and
  leaky ReLU 0.01 for the GN architecture); and hierarchical heads (a 3x3
  convolution at 1/8, then Conv1d MLPs at 1/4, 1/2 and 1/1 on the
  upsampled features and previous prediction) whose outputs are a unit
  normal and kappa = elu + 1.01. ``detect`` resizes to
  ``detect_resolution`` (512, controlnet_aux's default) and back,
  antialiased when it shrinks.

Module names are the checkpoints' keys, so ``ControlNetHED.pth`` loads with
``load_state_dict(strict=True)``; ``load_normalbae`` reads ``{"model":
state_dict}``, strips ``module.`` prefixes and drops the encoder's bn2,
which the NNET forward bypasses, before its strict load. Without a file
both run with random weights from a seeded generator.
``hed_state_dict_from_numpy`` and ``normalbae_state_dict_from_numpy`` take
the JAX package's parameter trees as numpy arrays. The detectors run in
fp32 and are frozen (eval mode, no gradient).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dreammat_tpu_torch.utils.hw import resolve_device

# (in_ch, out_ch, n_convs) per block of ControlNetHED_Apache2
_HED_BLOCKS: Tuple[Tuple[int, int, int], ...] = (
    (3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3),
)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` of [B,C,H,W]: half-pixel bilinear,
    antialiased when it shrinks."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


class _DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        self.convs = nn.Sequential(*(nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1)
                                     for i in range(n)))
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, h: torch.Tensor, down: bool):
        if down:
            h = F.max_pool2d(h, 2, 2)
        for conv in self.convs:
            h = F.relu(conv(h))
        return h, self.projection(h)


class ControlNetHED(nn.Module):
    """The HED edge network; ``forward`` gives the side maps, ``detect``
    the control image."""

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        for i, (ci, co, n) in enumerate(_HED_BLOCKS):
            setattr(self, f"block{i + 1}", _DoubleConvBlock(ci, co, n))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B,3,H,W] RGB in 0..255 -> the five side maps (logits)
        [B,1,H/2^i,W/2^i]."""
        h = x - self.norm
        sides = []
        for i in range(len(_HED_BLOCKS)):
            h, side = getattr(self, f"block{i + 1}")(h, down=i > 0)
            sides.append(side)
        return sides

    def detect(self, rgb: torch.Tensor, scribble: bool = False) -> torch.Tensor:
        """rgb [B,3,H,W] in [0,1] -> [B,3,H,W] edge map in [0,1]; binary
        with ``scribble``."""
        H, W = rgb.shape[-2:]
        ups = [resize_linear(s, (H, W)) for s in self(rgb * 255.0)]
        edge = torch.sigmoid(torch.stack(ups).mean(0))[:, 0]
        if scribble:
            edge = scribble_nms(edge)
        return edge[:, None].repeat(1, 3, 1, 1)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """[B,H,W] blurred along rows, then columns, by a normalized gaussian of
    radius max(round(3 sigma), 1), zero-padded ("same" convolution)."""
    radius = max(int(round(sigma * 3.0)), 1)
    t = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = torch.as_tensor(k / k.sum(), device=x.device, dtype=x.dtype)
    y = F.conv2d(x[:, None], k.view(1, 1, 1, -1), padding=(0, radius))
    return F.conv2d(y, k.view(1, 1, -1, 1), padding=(radius, 0))[:, 0]


def _directional_max(x: torch.Tensor, offsets) -> torch.Tensor:
    """Max over the 3-tap line through each pixel; the neighbours wrap
    around the border."""
    out = x
    for dy, dx in offsets:
        out = torch.maximum(out, torch.roll(x, shifts=(dy, dx), dims=(-2, -1)))
    return out


def scribble_nms(edge: torch.Tensor, thresh: float = 127.0 / 255.0,
                 sigma: float = 3.0) -> torch.Tensor:
    """[B,H,W] -> binary [B,H,W]: keep the pixels of the blurred map that
    are the max of a 3-tap line through them in some direction, threshold."""
    z = gaussian_blur(edge, sigma)
    y = torch.zeros_like(z)
    for offs in (((0, -1), (0, 1)), ((-1, 0), (1, 0)), ((-1, -1), (1, 1)),
                 ((-1, 1), (1, -1))):
        y = torch.where(_directional_max(z, offs) == z, z, y)
    return (y > thresh).float()


def soft_canny(rgb: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """[B,3,H,W] in [0,1] -> [B,3,H,W] edge map in [0,1]: the zero-padded
    Sobel magnitude of the luma, ramped from lower/255 to upper/255."""
    gray = (0.299 * rgb[:, 0] + 0.587 * rgb[:, 1] + 0.114 * rgb[:, 2])[:, None]
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=rgb.device, dtype=rgb.dtype)
    gx = F.conv2d(gray, kx.view(1, 1, 3, 3), padding=1)
    gy = F.conv2d(gray, kx.t().reshape(1, 1, 3, 3), padding=1)
    mag = torch.sqrt(gx * gx + gy * gy)
    lo, hi = lower / 255.0, upper / 255.0
    edge = torch.clamp((mag - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    return edge.repeat(1, 3, 1, 1)


# ---------------------------------------------------------------------------
# NormalBae
# ---------------------------------------------------------------------------

# (n_blocks, kernel, stride, expand_ratio, c_in, c_out) per stage
_B5_STAGES: Tuple[Tuple[int, int, int, int, int, int], ...] = (
    (3, 3, 1, 1, 48, 24),
    (5, 3, 2, 6, 24, 40),
    (5, 5, 2, 6, 40, 64),
    (7, 3, 2, 6, 64, 128),
    (7, 5, 1, 6, 128, 176),
    (9, 5, 2, 6, 176, 304),
    (3, 3, 1, 6, 304, 512),
)
_B5_STEM = 48
_B5_HEAD = 2048
_SKIP_STAGES = (0, 1, 2, 4)
_DEC_UPS = ((2048 + 176, 1024), (1024 + 64, 512), (512 + 40, 256), (256 + 24, 128))
_DEC_HEADS = {"res4": 512 + 4, "res2": 256 + 4, "res1": 128 + 4}
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def tf_same_pad(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    """TF/XLA "SAME" padding of [B,C,H,W]: total max((ceil(n/s)-1) s + k - n,
    0) per axis, the odd pixel after (bottom, right)."""
    pads = []
    for n, k, s in zip(x.shape[-2:], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF "SAME" padding (asymmetric on stride 2)."""

    def __init__(self, cin, cout, kernel_size, stride=1, groups=1, bias=False):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=0, groups=groups,
                         bias=bias)

    def forward(self, x):
        return F.conv2d(tf_same_pad(x, self.kernel_size, self.stride), self.weight, self.bias,
                        self.stride, 0, 1, self.groups)


class CenteredBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose inference is the JAX package's ``_bn``: the
    mean subtracted first, (x - mean) * (rsqrt(var + eps) * weight) + bias.
    PyTorch's CPU inference folds it into x * a + (bias - mean * a), which
    on a channel whose mean is large beside its spread (a flat region of a
    render, the statistics taken from that render) keeps the rounding of
    the large x * a in a small result: 160-1560 times the centred form's
    error against fp64 there (``tests/test_torch_normalbae_rounding.py``).
    Training (the statistics' update) is PyTorch's; the state dict is
    ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or self.running_mean is None:
            return super().forward(x)
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return torch.addcmul(self.bias[:, None, None], x - self.running_mean[:, None, None],
                             scale[:, None, None])


def _bn_tf(c: int) -> nn.BatchNorm2d:
    """The encoder's BatchNorm: the TF-ported weights use eps 1e-3."""
    return CenteredBatchNorm2d(c, eps=1e-3)


class WSConv2d(nn.Conv2d):
    """Weight-standardized convolution of the GN architecture: the weight's
    per-output-channel mean removed, divided by its Bessel std plus 1e-5."""

    def forward(self, x):
        w = self.weight
        w = w - w.mean(dim=(1, 2, 3), keepdim=True)
        w = w / (w.reshape(w.shape[0], -1).std(dim=1).reshape(-1, 1, 1, 1) + 1e-5)
        return F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, r: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, r, 1)
        self.conv_expand = nn.Conv2d(r, c, 1)

    def forward(self, x):
        s = F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(s))


class DepthwiseSeparable(nn.Module):
    """Stage 0's block: depthwise conv, BN, swish, SE, pointwise conv, BN."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, stride, groups=cin)
        self.bn1 = _bn_tf(cin)
        self.se = SqueezeExcite(cin, max(1, int(cin * 0.25)))
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = _bn_tf(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, h):
        y = self.se(F.silu(self.bn1(self.conv_dw(h))))
        y = self.bn2(self.conv_pw(y))
        return y + h if self.residual else y


class InvertedResidual(nn.Module):
    """MBConv: expand 1x1, depthwise, SE, project 1x1 (BN after each)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int):
        super().__init__()
        mid = cin * expand
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = _bn_tf(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid)
        self.bn2 = _bn_tf(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = _bn_tf(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, h):
        y = F.silu(self.bn1(self.conv_pw(h)))
        y = self.se(F.silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + h if self.residual else y


def make_stage(si: int) -> nn.Sequential:
    """MBConv stage ``si`` of the B5 encoder."""
    n, k, s, e, ci, co = _B5_STAGES[si]
    block = DepthwiseSeparable if e == 1 else (
        lambda cin, cout, k, stride: InvertedResidual(cin, cout, k, stride, e))
    return nn.Sequential(*(block(ci if bi == 0 else co, co, k, s if bi == 0 else 1)
                           for bi in range(n)))


class EfficientNetB5(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_stem = Conv2dSame(3, _B5_STEM, 3, 2)
        self.bn1 = _bn_tf(_B5_STEM)
        self.blocks = nn.Sequential(*(make_stage(si) for si in range(len(_B5_STAGES))))
        self.conv_head = nn.Conv2d(_B5_STAGES[-1][5], _B5_HEAD, 1, bias=False)

    def forward(self, x) -> List[torch.Tensor]:
        """[stage0, stage1, stage2, stage4, conv_head before bn2]."""
        h = F.silu(self.bn1(self.conv_stem(x)))
        skips = []
        for si, stage in enumerate(self.blocks):
            h = stage(h)
            if si in _SKIP_STAGES:
                skips.append(h)
        skips.append(self.conv_head(h))
        return skips


class _Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.original_model = EfficientNetB5()


class UpBlock(nn.Module):
    """Upsample (align_corners) to the skip, concat, two conv-norm-leaky
    ReLU layers."""

    def __init__(self, cin: int, cout: int, gn: bool):
        super().__init__()
        conv = WSConv2d if gn else nn.Conv2d
        norm = (lambda c: nn.GroupNorm(8, c)) if gn else CenteredBatchNorm2d
        self._net = nn.Sequential(conv(cin, cout, 3, padding=1), norm(cout), nn.LeakyReLU(0.01),
                                  conv(cout, cout, 3, padding=1), norm(cout), nn.LeakyReLU(0.01))

    def forward(self, x, skip):
        ux = F.interpolate(x, size=skip.shape[-2:], mode="bilinear", align_corners=True)
        return self._net(torch.cat([ux, skip], dim=1))


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """[B,4,H,W] (nx,ny,nz,kappa) -> unit normal and elu(kappa) + 1.01."""
    n, kappa = out[:, :3], out[:, 3:4]
    norm = torch.sqrt(torch.sum(n * n, dim=1, keepdim=True)) + 1e-10
    return torch.cat([n / norm, F.elu(kappa) + 1.0 + 0.01], dim=1)


def _mlp_head(cin: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(cin, 128, 1), nn.ReLU(), nn.Conv1d(128, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 128, 1), nn.ReLU(), nn.Conv1d(128, 4, 1))


class _Decoder(nn.Module):
    def __init__(self, gn: bool):
        super().__init__()
        self.conv2 = nn.Conv2d(_B5_HEAD, _B5_HEAD, 1)
        for ui, (cin, cout) in enumerate(_DEC_UPS):
            setattr(self, f"up{ui + 1}", UpBlock(cin, cout, gn))
        self.out_conv_res8 = nn.Conv2d(512, 4, 3, padding=1)
        for name, cin in _DEC_HEADS.items():
            setattr(self, f"out_conv_{name}", _mlp_head(cin))

    def forward(self, feats) -> List[torch.Tensor]:
        s0, s1, s2, s4, head = feats
        x_d1 = self.up1(self.conv2(head), s4)
        x_d2 = self.up2(x_d1, s2)
        x_d3 = self.up3(x_d2, s1)
        x_d4 = self.up4(x_d3, s0)
        out_res8 = norm_normalize(self.out_conv_res8(x_d2))

        def mlp(layers, feat, prev):
            B, _, H, W = feat.shape
            up = lambda t: F.interpolate(t, size=(2 * H, 2 * W), mode="bilinear",
                                         align_corners=True)
            h = torch.cat([up(feat), up(prev)], dim=1)
            return norm_normalize(layers(h.reshape(B, h.shape[1], -1)).reshape(B, 4, 2 * H, 2 * W))

        out_res4 = mlp(self.out_conv_res4, x_d2, out_res8)
        out_res2 = mlp(self.out_conv_res2, x_d3, out_res4)
        out_res1 = mlp(self.out_conv_res1, x_d4, out_res2)
        return [out_res8, out_res4, out_res2, out_res1]


class NormalBae(nn.Module):
    """The NNET surface-normal estimator; ``forward`` gives the four
    predictions, ``detect`` the control image."""

    def __init__(self, architecture: str = "GN", detect_resolution: int = 512):
        super().__init__()
        self.architecture = architecture
        self.detect_resolution = detect_resolution
        self.encoder = _Encoder()
        self.decoder = _Decoder(architecture == "GN")

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """ImageNet-normalized [B,3,H,W] -> [res8, res4, res2, res1], each
        [B,4,h,w] (unit normal, kappa)."""
        return self.decoder(self.encoder.original_model(x))

    def detect(self, rgb: torch.Tensor) -> torch.Tensor:
        """rgb [B,3,H,W] in [0,1] -> [B,3,H,W] normal image (n+1)/2 in [0,1]."""
        H, W = rgb.shape[-2:]
        dr = self.detect_resolution
        x = resize_linear(rgb, (dr, dr))
        mean = torch.tensor(_IMAGENET_MEAN, device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
        std = torch.tensor(_IMAGENET_STD, device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
        normal = self((x - mean) / std)[-1][:, :3]
        return resize_linear(torch.clamp((normal + 1.0) * 0.5, 0.0, 1.0), (H, W))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _he_init_(module: nn.Module, generator: torch.Generator, fan_gain=None) -> None:
    """The JAX package's detector init: conv weights normal * sqrt(2/fan_in)
    (``fan_gain(module)`` overrides the 2), biases 0, norms at identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan = m.weight[0].numel()
            gain = fan_gain(m) if fan_gain else 2.0
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * math.sqrt(gain / fan))
            if m.bias is not None:
                m.bias.zero_()


def _frozen(module: nn.Module, device) -> nn.Module:
    return module.to(device).eval().requires_grad_(False)


def _read(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def load_hed(weights_path: Optional[str] = None, device="cuda", seed: int = 0) -> ControlNetHED:
    """``ControlNetHED.pth`` loaded strictly when given, random weights from
    ``seed`` otherwise; fp32, frozen, on ``device``."""
    device = resolve_device(device)
    model = ControlNetHED()
    if weights_path:
        model.load_state_dict(_read(weights_path), strict=True)
    else:
        projections = {getattr(model, f"block{i + 1}").projection for i in range(len(_HED_BLOCKS))}
        _he_init_(model, torch.Generator().manual_seed(seed),
                  fan_gain=lambda m: 1.0 if m in projections else 2.0)
    return _frozen(model, device)


# the encoder's bn2 follows conv_head, whose output the NNET forward takes
_NORMALBAE_BYPASSED = "encoder.original_model.bn2."


@torch.no_grad()
def load_normalbae(weights_path: Optional[str] = None, device="cuda", seed: int = 0,
                   architecture: str = "GN", detect_resolution: int = 512) -> NormalBae:
    """``scannet.pt`` (``{"model": state_dict}``, ``module.`` prefixes
    stripped, the bypassed bn2 dropped) loaded strictly when given, random
    weights from ``seed`` otherwise; fp32, frozen, on ``device``."""
    device = resolve_device(device)
    model = NormalBae(architecture, detect_resolution)
    if weights_path:
        sd = _read(weights_path)
        if "model" in sd and not torch.is_tensor(sd["model"]):
            sd = sd["model"]
        sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
        sd = {k: v for k, v in sd.items() if not k.startswith(_NORMALBAE_BYPASSED)}
        model.load_state_dict(sd, strict=True)
    else:
        _he_init_(model, torch.Generator().manual_seed(seed))
    return _frozen(model, device)


def _conv_from_numpy(w: np.ndarray) -> torch.Tensor:
    """[kh,kw,ci,co] (depthwise [kh,kw,1,c]) -> [co,ci,kh,kw]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def hed_state_dict_from_numpy(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's HED parameter tree (numpy leaves) as a
    ``ControlNetHED`` state dict."""
    sd = {"norm": _vec(tree["norm"]).reshape(1, 3, 1, 1)}
    for bi, (_, _, n) in enumerate(_HED_BLOCKS):
        blk, t = tree[f"block{bi + 1}"], f"block{bi + 1}."
        for li in range(n):
            sd[t + f"convs.{li}.weight"] = _conv_from_numpy(blk[f"conv{li}"]["w"])
            sd[t + f"convs.{li}.bias"] = _vec(blk[f"conv{li}"]["b"])
        sd[t + "projection.weight"] = _conv_from_numpy(blk["projection"]["w"])
        sd[t + "projection.bias"] = _vec(blk["projection"]["b"])
    return sd


_BN_STATS = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
             ("var", "running_var"))


def normalbae_key_map(architecture: str = "GN") -> List[Tuple[Tuple[Any, ...], str, str]]:
    """(path in the JAX tree, state-dict key, kind) for every parameter;
    kind is "conv" ([kh,kw,ci,co]), "conv1d" ([1,1,ci,co] -> [co,ci,1]) or
    "vec"."""
    out = []
    e = "encoder.original_model."

    def bn(path, key, stats=_BN_STATS):
        out.extend(((*path, s), f"{key}.{t}", "vec") for s, t in stats)

    out.append((("encoder", "conv_stem", "w"), e + "conv_stem.weight", "conv"))
    bn(("encoder", "bn1"), e + "bn1")
    for si, (n, _, _, ex, _, _) in enumerate(_B5_STAGES):
        for bi in range(n):
            f, t = ("encoder", f"blocks_{si}_{bi}"), e + f"blocks.{si}.{bi}."
            convs = ("conv_dw", "conv_pw") if ex == 1 else ("conv_pw", "conv_dw", "conv_pwl")
            for c in convs:
                out.append(((*f, c, "w"), t + c + ".weight", "conv"))
            for b in (("bn1", "bn2") if ex == 1 else ("bn1", "bn2", "bn3")):
                bn((*f, b), t + b)
            for c in ("conv_reduce", "conv_expand"):
                out.append(((*f, "se", c, "w"), t + f"se.{c}.weight", "conv"))
                out.append(((*f, "se", c, "b"), t + f"se.{c}.bias", "vec"))
    out.append((("encoder", "conv_head", "w"), e + "conv_head.weight", "conv"))
    d = "decoder."
    out.append((("decoder", "conv2", "w"), d + "conv2.weight", "conv"))
    out.append((("decoder", "conv2", "b"), d + "conv2.bias", "vec"))
    norm_stats = _BN_STATS[:2] if architecture == "GN" else _BN_STATS
    for ui in range(len(_DEC_UPS)):
        f, t = ("decoder", f"up{ui + 1}"), d + f"up{ui + 1}._net."
        for name, idx in (("conv0", 0), ("conv1", 3)):
            out.append(((*f, name, "w"), t + f"{idx}.weight", "conv"))
            out.append(((*f, name, "b"), t + f"{idx}.bias", "vec"))
        for name, idx in (("norm0", 1), ("norm1", 4)):
            bn((*f, name), t + str(idx), norm_stats)
    out.append((("decoder", "out_conv_res8", "w"), d + "out_conv_res8.weight", "conv"))
    out.append((("decoder", "out_conv_res8", "b"), d + "out_conv_res8.bias", "vec"))
    for name in _DEC_HEADS:
        for li, idx in enumerate((0, 2, 4, 6)):
            f = ("decoder", f"out_conv_{name}", li)
            out.append(((*f, "w"), d + f"out_conv_{name}.{idx}.weight", "conv1d"))
            out.append(((*f, "b"), d + f"out_conv_{name}.{idx}.bias", "vec"))
    return out


def normalbae_state_dict_from_numpy(tree: Mapping[str, Any],
                                    architecture: str = "GN") -> Dict[str, torch.Tensor]:
    """The JAX package's NormalBae parameter tree (numpy leaves) as a
    ``NormalBae`` state dict."""
    sd = {}
    for path, key, kind in normalbae_key_map(architecture):
        x = tree
        for p in path:
            x = x[p]
        if kind == "conv":
            sd[key] = _conv_from_numpy(x)
        elif kind == "conv1d":
            sd[key] = _vec(np.asarray(x)[0, 0].T[:, :, None])
        else:
            sd[key] = _vec(x)
    return sd
