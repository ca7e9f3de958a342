"""Port parity: the HED and NormalBae detectors and ``soft_canny`` against JAX.

The parameters are made with numpy in the JAX package's tree layout and
carried to the port by ``hed_state_dict_from_numpy`` and
``normalbae_state_dict_from_numpy``. fp32 on the CPU; tolerances:

- HED side maps at 64^2 to 1e-4 of their largest magnitude, the edge map
  to 1e-4 absolute; the scribble map (binary) and ``scribble_nms`` equal
  on at least 99.9% of pixels, since a pixel on a blurred ridge whose
  neighbours tie to the last bit may flip (the test weights give an edge
  map with ridges, not a flat one); ``soft_canny`` to 1e-5.
- NormalBae block by block (a TF-"SAME" stride-2 convolution and a 5x5
  stride-2 depthwise one at odd and even sizes, the encoder BatchNorm with
  eps 1e-3, the weight-standardized convolution, GroupNorm(8), the
  squeeze-excite, align-corners upsampling, MBConv stage 1, a decoder
  up-block) to 1e-4 relative to the output's scale, and the whole forward
  at 32^2, all four predictions, to 1e-4 absolute (unit normals and kappa
  of order 1), and the detector's resize to ``detect_resolution`` and back
  (both ways) likewise.
- Both packages' loaders read the same ``ControlNetHED.pth`` and
  ``scannet.pt`` (``{"model": ...}`` with ``module.`` prefixes, and the
  encoder's bn2, which the forward bypasses) written here; the port's
  load is strict and both give the same outputs. The JAX NormalBae loader
  random-initializes before it loads, eagerly, leaf by leaf (tens of
  seconds on a CPU), so the test hands it the numpy tree as that initial
  tree: every leaf is then overwritten by the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dreammat_tpu.models import detectors as jdet
from dreammat_tpu.models import guidance_triple as jtriple
from dreammat_tpu_torch.models import detectors as tdet


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _conv_w(rs, kh, kw, ci, co):
    return (rs.randn(kh, kw, ci, co) * np.sqrt(2.0 / (kh * kw * ci))).astype(np.float32)


# ---------------------------------------------------------------------------
# HED
# ---------------------------------------------------------------------------

def _hed_tree(seed=0):
    rs = np.random.RandomState(seed)
    tree = {"norm": rs.uniform(100, 140, (1, 1, 1, 3)).astype(np.float32)}
    for bi, (ci, co, n) in enumerate(jdet._HED_BLOCKS):
        blk = {}
        for li in range(n):
            blk[f"conv{li}"] = {"w": _conv_w(rs, 3, 3, ci if li == 0 else co, co) * 0.2,
                                "b": (0.01 * rs.randn(co)).astype(np.float32)}
        blk["projection"] = {"w": _conv_w(rs, 1, 1, co, 1),
                             "b": (0.1 * rs.randn(1)).astype(np.float32)}
        tree[f"block{bi + 1}"] = blk
    return tree


@pytest.fixture(scope="module")
def hed_pair(tmp_path_factory):
    """(JAX tree, port model), both read from one ControlNetHED.pth."""
    tree = _hed_tree()
    path = str(tmp_path_factory.mktemp("hed") / "ControlNetHED.pth")
    torch.save(tdet.hed_state_dict_from_numpy(tree), path)
    jhed = jdet.load_hed(path)
    thed = tdet.load_hed(path, device="cpu")
    return tree, jhed, thed


def test_hed_loaders_read_the_same_file(hed_pair):
    tree, jhed, thed = hed_pair
    assert thed.training is False and not any(p.requires_grad for p in thed.parameters())
    got = jax.tree_util.tree_map(np.asarray, jhed.params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(a.reshape(b.shape), b)
    sd = tdet.hed_state_dict_from_numpy(tree)
    assert set(sd) == set(thed.state_dict())
    assert all(torch.equal(thed.state_dict()[k], v) for k, v in sd.items())
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tdet.ControlNetHED().load_state_dict({**sd, "block6.projection.bias": sd["norm"]},
                                             strict=True)


def test_hed_side_maps_match_jax(hed_pair):
    tree, jhed, thed = hed_pair
    x = np.random.RandomState(1).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    js = jax.jit(jdet.hed_side_maps)(jhed.params, jnp.asarray(x))
    with torch.no_grad():
        ts = thed(_nchw(x))
    assert [tuple(t.shape[-2:]) for t in ts] == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    for j, t in zip(js, ts):
        assert np.abs(_nhwc(t) - np.asarray(j)).max() <= 1e-4 * max(1.0, np.abs(j).max())


@pytest.mark.parametrize("scribble", [False, True])
def test_hed_detector_matches_jax(hed_pair, scribble):
    _, jhed, thed = hed_pair
    rgb = np.random.RandomState(2).uniform(size=(64, 64, 3)).astype(np.float32)
    j = np.asarray(jax.jit(lambda p, im: jdet.HEDdetector(p)(im, scribble=scribble))(
        jhed.params, jnp.asarray(rgb)))
    with torch.no_grad():
        t = _nhwc(thed.detect(_nchw(rgb[None]), scribble=scribble))[0]
    assert t.shape == j.shape == (64, 64, 3)
    if scribble:
        assert set(np.unique(t).tolist()) <= {0.0, 1.0}
        assert (t != j).mean() <= 1e-3 and 0 < t.mean() < 1
    else:
        assert np.abs(t - j).max() <= 1e-4 and 0.0 <= t.min() and t.max() <= 1.0


def test_scribble_nms_matches_jax():
    """A smooth random map (and a wrapped border: the neighbours of the
    first row are the last row's, as in the JAX package)."""
    rs = np.random.RandomState(3)
    edge = F.avg_pool2d(torch.from_numpy(rs.uniform(size=(1, 1, 72, 72)).astype(np.float32)),
                        9, 1)[0, 0].numpy() * 1.5 - 0.25
    edge[0] = edge[-1] + 0.3  # the wrapped border decides the first row
    j = np.asarray(jdet.scribble_nms(jnp.asarray(edge)))
    t = tdet.scribble_nms(torch.from_numpy(edge)[None])[0].numpy()
    assert t.shape == j.shape == (64, 64)
    assert (t != j).mean() <= 1e-3 and t.sum() > 0
    jb = np.asarray(jdet._gaussian_blur(jnp.asarray(edge), 3.0))
    tb = tdet.gaussian_blur(torch.from_numpy(edge)[None], 3.0)[0].numpy()
    assert np.abs(tb - jb).max() <= 1e-6


def test_soft_canny_matches_jax():
    rs = np.random.RandomState(4)
    img = rs.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    img[:, :, 32:] += 0.5
    j = np.asarray(jtriple.soft_canny(jnp.asarray(img), 50, 100))
    t = _nhwc(tdet.soft_canny(_nchw(img), 50, 100))
    assert np.abs(t - j).max() <= 1e-5 and 0 < t.mean() < 1


# ---------------------------------------------------------------------------
# NormalBae
# ---------------------------------------------------------------------------

def _vec_leaf(rs, leaf, shape):
    return {"scale": 1 + 0.1 * rs.randn(*shape), "bias": 0.1 * rs.randn(*shape),
            "mean": 0.1 * rs.randn(*shape), "var": rs.uniform(0.5, 1.5, shape),
            "b": 0.1 * rs.randn(*shape)}[leaf].astype(np.float32)


def _normalbae_tree(seed=0):
    """A random NormalBae tree in the JAX layout, from numpy (the shapes
    from the port's key map and modules)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in tdet.NormalBae().state_dict().items()}
    rs = np.random.RandomState(seed)
    tree = {}
    for path, key, kind in tdet.normalbae_key_map():
        s = shapes[key]
        if kind == "conv":
            x = _conv_w(rs, s[2], s[3], s[1], s[0])
        elif kind == "conv1d":
            x = _conv_w(rs, 1, 1, s[1], s[0])
        else:
            x = _vec_leaf(rs, path[-1], s)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = x

    def listify(n):
        if isinstance(n, dict):
            if n and all(isinstance(k, int) for k in n):
                return [listify(n[i]) for i in range(len(n))]
            return {k: listify(v) for k, v in n.items()}
        return n

    return {"architecture": "GN", **listify(tree)}


@pytest.fixture(scope="module")
def normalbae_pair(tmp_path_factory):
    """(tree, JAX params, port model), both read from one scannet.pt."""
    tree = _normalbae_tree()
    sd = tdet.normalbae_state_dict_from_numpy(tree)
    bn2 = {f"encoder.original_model.bn2.{k}": torch.ones(2048)
           for k in ("weight", "bias", "running_mean", "running_var")}
    path = str(tmp_path_factory.mktemp("normalbae") / "scannet.pt")
    torch.save({"model": {f"module.{k}": v for k, v in {**sd, **bn2}.items()}}, path)
    skeleton = jax.tree_util.tree_map(lambda x: np.zeros_like(x) if hasattr(x, "shape") else x,
                                      tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "init_normalbae_params", lambda rng, arch="GN": skeleton)
        jparams = jdet.load_normalbae(path).params
    return tree, jparams, tdet.load_normalbae(path, device="cpu")


def test_normalbae_loaders_read_the_same_file(normalbae_pair):
    tree, jparams, tnb = normalbae_pair
    for a, b in zip(jax.tree_util.tree_leaves({k: v for k, v in jparams.items()
                                               if k != "architecture"}),
                    jax.tree_util.tree_leaves({k: v for k, v in tree.items()
                                               if k != "architecture"})):
        assert np.array_equal(np.asarray(a), b)
    sd = tdet.normalbae_state_dict_from_numpy(tree)
    got = tnb.state_dict()
    assert set(got) - set(sd) == {k for k in got if k.endswith("num_batches_tracked")}
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(RuntimeError, match="Missing key"):
        tdet.NormalBae().load_state_dict({k: v for k, v in sd.items()
                                          if not k.startswith("decoder.up1.")}, strict=True)


def _close(t, j, tol=1e-4):
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= tol * max(1.0, np.abs(j).max()), np.abs(t - j).max()


def test_normalbae_forward_matches_jax(normalbae_pair):
    _, jparams, tnb = normalbae_pair
    x = np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32)
    p = {k: v for k, v in jparams.items() if k != "architecture"}
    j = jax.jit(lambda p, x: jdet.normalbae_forward({**p, "architecture": "GN"}, x))(p, x)
    with torch.no_grad():
        t = tnb(_nchw(x))
    assert [tuple(a.shape[-2:]) for a in t] == [(4, 4), (8, 8), (16, 16), (32, 32)]
    for a, b in zip(t, j):
        _close(_nhwc(a), b)
        n = _nhwc(a)[..., :3]
        assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-4)


@pytest.mark.parametrize("size", [24, 40])
def test_normalbae_detect_resize_matches_jax(normalbae_pair, size, monkeypatch):
    """The resize to ``detect_resolution`` (32 here) and back, up and down."""
    _, jparams, tnb = normalbae_pair
    monkeypatch.setattr(jdet.NormalBaeDetector, "detect_resolution", 32)
    tnb = tdet.NormalBae(detect_resolution=32)
    tnb.load_state_dict(normalbae_pair[2].state_dict(), strict=True)
    tnb.eval()
    rgb = np.random.RandomState(6).uniform(size=(size, size, 3)).astype(np.float32)
    j = jax.jit(lambda p, im: jdet.NormalBaeDetector({**p, "architecture": "GN"})(im))(
        {k: v for k, v in jparams.items() if k != "architecture"}, rgb)
    with torch.no_grad():
        t = _nhwc(tnb.detect(_nchw(rgb[None])))[0]
    _close(t, j)
    assert t.shape == (size, size, 3) and 0.0 <= t.min() and t.max() <= 1.0


def _bn_params(rs, c):
    return {k: _vec_leaf(rs, k, (c,)) for k in ("scale", "bias", "mean", "var")}


def _load_bn(bn, p):
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(p["mean"]),
                        "running_var": torch.from_numpy(p["var"])}, strict=False)
    return bn.eval()


@pytest.mark.parametrize("k,groups", [(3, 1), (5, "depthwise")])
@pytest.mark.parametrize("size", [15, 16])
def test_tf_same_stride2_conv_matches_jax(k, groups, size):
    rs = np.random.RandomState(size + k)
    c = 8
    g = c if groups == "depthwise" else 1
    w = _conv_w(rs, k, k, c // g, c)
    x = rs.randn(1, size, size, c).astype(np.float32)
    j = jdet._conv2d(jnp.asarray(x), {"w": jnp.asarray(w)}, stride=2, groups=g)
    conv = tdet.Conv2dSame(c, c, k, 2, groups=g)
    conv.weight.data = tdet._conv_from_numpy(w)
    with torch.no_grad():
        t = _nhwc(conv(_nchw(x)))
    assert t.shape[1] == -(-size // 2)
    _close(t, j)


def test_normalbae_norms_and_convs_match_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, 11, 16).astype(np.float32)
    bn = _bn_params(rs, 16)
    with torch.no_grad():
        _close(_nhwc(_load_bn(tdet._bn_tf(16), bn)(_nchw(x))), jdet._bn_tf(jnp.asarray(x), bn))
        gn = {"scale": _vec_leaf(rs, "scale", (16,)), "bias": _vec_leaf(rs, "bias", (16,))}
        tgn = torch.nn.GroupNorm(8, 16)
        tgn.weight.data, tgn.bias.data = torch.from_numpy(gn["scale"]), torch.from_numpy(gn["bias"])
        _close(_nhwc(tgn(_nchw(x))), jdet._gn(jnp.asarray(x), gn))
        ws = {"w": _conv_w(rs, 3, 3, 16, 24) + 0.05, "b": _vec_leaf(rs, "b", (24,))}
        conv = tdet.WSConv2d(16, 24, 3, padding=1)
        conv.weight.data, conv.bias.data = tdet._conv_from_numpy(ws["w"]), torch.from_numpy(ws["b"])
        _close(_nhwc(conv(_nchw(x))), jdet._ws_conv2d(jnp.asarray(x), ws))
        se = {"conv_reduce": {"w": _conv_w(rs, 1, 1, 16, 4), "b": _vec_leaf(rs, "b", (4,))},
              "conv_expand": {"w": _conv_w(rs, 1, 1, 4, 16), "b": _vec_leaf(rs, "b", (16,))}}
        tse = tdet.SqueezeExcite(16, 4)
        for name in ("conv_reduce", "conv_expand"):
            getattr(tse, name).weight.data = tdet._conv_from_numpy(se[name]["w"])
            getattr(tse, name).bias.data = torch.from_numpy(se[name]["b"])
        _close(_nhwc(tse(_nchw(x))), jdet._se(jnp.asarray(x), se))
        up = F.interpolate(_nchw(x), size=(17, 23), mode="bilinear", align_corners=True)
        _close(_nhwc(up), jdet._up_align_corners(jnp.asarray(x), 17, 23), tol=1e-5)


def test_mbconv_stage_matches_jax(normalbae_pair):
    """Stage 1 of the encoder (24 -> 40, stride 2, five blocks) on its own,
    against the JAX package's block loop."""
    _, jparams, tnb = normalbae_pair
    enc = jparams["encoder"]
    x = np.random.RandomState(8).randn(1, 17, 17, 24).astype(np.float32)
    h = jnp.asarray(x)
    n, k, s, e, ci, co = jdet._B5_STAGES[1]
    for bi in range(n):
        blk = enc[f"blocks_1_{bi}"]
        stride = s if bi == 0 else 1
        y = jdet._swish(jdet._bn_tf(jdet._conv2d(h, blk["conv_pw"]), blk["bn1"]))
        y = jdet._swish(jdet._bn_tf(jdet._conv2d(y, blk["conv_dw"], stride=stride,
                                                 groups=y.shape[-1]), blk["bn2"]))
        y = jdet._bn_tf(jdet._conv2d(jdet._se(y, blk["se"]), blk["conv_pwl"]), blk["bn3"])
        h = y + h if (stride == 1 and y.shape[-1] == h.shape[-1]) else y
    with torch.no_grad():
        t = _nhwc(tnb.encoder.original_model.blocks[1](_nchw(x)))
    assert t.shape == (1, 9, 9, 40)
    _close(t, h)


def test_decoder_up_block_matches_jax(normalbae_pair):
    """``up4`` (256 + 24 -> 128): align-corners upsampling to the skip,
    weight-standardized convolutions, GroupNorm(8), leaky ReLU 0.01."""
    _, jparams, tnb = normalbae_pair
    rs = np.random.RandomState(9)
    x = rs.randn(1, 5, 5, 256).astype(np.float32)
    skip = rs.randn(1, 10, 9, 24).astype(np.float32)
    p = jparams["decoder"]["up4"]
    h = jnp.concatenate([jdet._up_align_corners(jnp.asarray(x), 10, 9), jnp.asarray(skip)], -1)
    h = jax.nn.leaky_relu(jdet._gn(jdet._ws_conv2d(h, p["conv0"]), p["norm0"]), 0.01)
    h = jax.nn.leaky_relu(jdet._gn(jdet._ws_conv2d(h, p["conv1"]), p["norm1"]), 0.01)
    with torch.no_grad():
        t = _nhwc(tnb.decoder.up4(_nchw(x), _nchw(skip)))
    _close(t, h)
