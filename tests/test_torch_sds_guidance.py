"""Port parity: the SDS guidance (``stable-diffusion-guidance``) against JAX.

Both packages run the tiny diffusion stack (UNet, VAE and a depth
ControlNet) with the same weights, carried over by the weight bridge; the
JAX package's weights are filled from numpy, and the port is handed the
draws the JAX guidance makes from its key (``vae_eps``, ``t``, ``noise``).
Each case compares ``loss_sds``, its gradient with respect to the rendered
image and ``grad_norm`` in fp32, to relative 1e-4 (the gradient as a
relative L2 norm): the three weightings, SJC with and without
``var_red``, ``rgb_as_latents``, the depth ControlNet on a live condition
map, and Perp-Neg at batch 1.

Perp-Neg at batch 2 shows a fault of the JAX package: its prompt
embeddings interleave the two negatives per sample, but its SDS guidance
takes them in blocks (``eps_neg[i*B:(i+1)*B]``), so sample b meets the
wrong negative. The port takes ``eps_neg[i::2]``; the test computes that
formula by hand from the port's own noise prediction and requires the
port to equal it and to differ from the JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.models  # noqa: F401
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.prompt import PromptEmbeddings as JPE
from dreammat_tpu_torch.models.diffusion.convert import flax_to_torch_state_dict
from dreammat_tpu_torch.models.diffusion.scheduler import add_noise
from dreammat_tpu_torch.models.prompt import PromptEmbeddings as TPE
from dreammat_tpu_torch.utils.ops import perpendicular_component

RTOL = 1e-4
HW = 32
CFG = {"model_size": "tiny", "half_precision_weights": False, "width": HW, "height": HW,
       "cache_dir": None, "controlnet_path": None, "use_controlnet": True,
       "control_types": ["depth"], "condition_scales": [1.0], "condition_scales_anneal": [1.0],
       "guidance_scale": 7.5, "min_step_percent": 0.02, "max_step_percent": 0.98}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _numpy_random_init(rng, init_fn):
    """``fast_random_init``'s fill (normal(0, 0.05), norm scales 1, biases 0)
    from numpy, seeded from the key."""
    seed = int(np.asarray(jax.random.key_data(rng)).ravel()[-1]) % (2 ** 31)
    gen = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name == "scale":
            return jnp.ones(s.shape, s.dtype)
        if name == "bias":
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(gen.normal(0.0, 0.05, s.shape).astype(s.dtype))

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


class GivenDraws:
    def __init__(self, draws):
        self.draws = draws

    def uniform(self, name, shape):
        assert tuple(self.draws[name].shape) == tuple(shape), name
        return torch.from_numpy(np.array(self.draws[name]))

    normal = uniform


def _nchw(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def _embeddings(N=16, D=64, seed=1):
    rng = np.random.RandomState(seed)
    shapes = {"text_vd": (4, N, D), "uncond_vd": (4, N, D), "text": (N, D), "uncond": (N, D),
              "null": (N, D)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jg = dreammat_tpu.find("stable-diffusion-guidance")(CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find("stable-diffusion-guidance")(CFG, device="cpu")
    tg.init_params()
    gp = jax.tree_util.tree_map(np.asarray, jg.params)
    tg.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    tg.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    tg.controlnets[0].load_state_dict(flax_to_torch_state_dict(gp["controlnets"][0],
                                                               "controlnet"), strict=True)
    emb = _embeddings()
    return jg, tg, emb


def _inputs(B, latents=False, seed=3):
    rng = np.random.RandomState(seed)
    C = 4 if latents else 3
    rgb = rng.uniform(size=(B, HW, HW, C)).astype(np.float32)
    cond = rng.uniform(size=(B, HW // 2, HW // 2, 4)).astype(np.float32)
    elev = np.float32([10.0, 30.0][:B])
    azim = np.float32([40.0, -120.0][:B])
    return rgb, cond, elev, azim, np.full((B,), 3.5, np.float32)


def _run(jg, tg, emb, B, perp_neg=False, rgb_as_latents=False, with_cond=False, step=100,
         key=5):
    """(JAX, port) of (loss, d loss / d rgb [B,H,W,C], grad_norm)."""
    rgb, cond, elev, azim, dist = _inputs(B, rgb_as_latents)
    je = JPE(**{k: jnp.asarray(v) for k, v in emb.items()}, use_perp_neg=perp_neg)
    te = TPE(**{k: torch.from_numpy(v) for k, v in emb.items()}, use_perp_neg=perp_neg)
    k = jax.random.PRNGKey(key)
    jcond = jnp.asarray(cond) if with_cond else None

    def jloss(x):
        out = jg(jg.params, x, je, jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist),
                 jcond, jnp.int32(step), k, rgb_as_latents=rgb_as_latents)
        return out["loss_sds"], out["grad_norm"]

    (j_loss, j_gn), j_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(rgb))

    k_enc, k_t, k_noise = jax.random.split(k, 3)
    f = tg.vae_factor
    lat = (B, HW // f, HW // f, 4)
    draws = {"t": np.asarray(jax.random.uniform(k_t, (B,))),
             "noise": _nchw(jax.random.normal(k_noise, lat))}
    if not rgb_as_latents:
        draws["vae_eps"] = _nchw(jax.random.normal(k_enc, lat))
    x = torch.from_numpy(_nchw(rgb)).requires_grad_(True)
    out = tg(x, te, torch.from_numpy(elev), torch.from_numpy(azim), torch.from_numpy(dist),
             torch.from_numpy(_nchw(cond)) if with_cond else None, step=step,
             draws=GivenDraws(draws), rgb_as_latents=rgb_as_latents)
    out["loss_sds"].backward()
    t_grad = np.moveaxis(x.grad.numpy(), 1, -1)
    return ((float(j_loss), np.asarray(j_grad), float(j_gn)),
            (float(out["loss_sds"].detach()), t_grad, float(out["grad_norm"])), draws, te,
            x.detach())


def _options(g, weighting="sds", sjc=False, var_red=True):
    g.cfg.weighting_strategy = weighting
    g.cfg.use_sjc = sjc
    g.cfg.var_red = var_red


CASES = {
    "sds": dict(), "uniform": dict(weighting="uniform"),
    "fantasia3d": dict(weighting="fantasia3d"),
    "sjc_var_red": dict(sjc=True, var_red=True), "sjc_no_var_red": dict(sjc=True, var_red=False),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["rgb_as_latents", "depth_controlnet",
                                                  "perp_neg_b1"])
def test_sds_guidance_matches_jax(pair, case):
    jg, tg, emb = pair
    for g in (jg, tg):
        _options(g, **CASES.get(case, {}))
    (jl, jgrad, jgn), (tl, tgrad, tgn), *_ = _run(
        jg, tg, emb, B=1, perp_neg=case == "perp_neg_b1",
        rgb_as_latents=case == "rgb_as_latents", with_cond=case == "depth_controlnet")
    assert np.isfinite(tl) and tl > 0
    assert abs(tl - jl) <= RTOL * abs(jl), (tl, jl)
    assert abs(tgn - jgn) <= RTOL * abs(jgn), (tgn, jgn)
    assert _rel(tgrad, jgrad) <= RTOL, _rel(tgrad, jgrad)
    assert np.abs(jgrad).max() > 0


def test_perp_neg_batch2_interleaved_and_jax_block_fault(pair):
    """At B = 2 the port follows the interleaved layout of the negatives,
    and the JAX package (blocks) gives another loss."""
    jg, tg, emb = pair
    for g in (jg, tg):
        _options(g)
    B, step = 2, 100
    (jl, _, _), (tl, _, tgn), draws, te, x = _run(jg, tg, emb, B=B, perp_neg=True, step=step)

    # the formula by hand, on the port's own noise prediction
    with torch.no_grad():
        lat = tg.encode_images(x, torch.from_numpy(draws["vae_eps"]))
        t, _, _ = tg._timesteps(B, step, GivenDraws(draws))
        noise = torch.from_numpy(draws["noise"])
        z = add_noise(tg.schedule, lat, noise, t)
        elev, azim, dist = (torch.from_numpy(v) for v in _inputs(B)[2:])
        emb4, neg_w = te.get_text_embeddings_perp_neg(elev, azim, dist, return_null=False)
        eps = tg.noise_pred(z, t, emb4, None, [], 4)
        e_text, e_unc = eps[:B], eps[B:2 * B]
        e_pos = e_text - e_unc
        acc = torch.zeros_like(e_pos)
        for b in range(B):
            for i in range(2):
                neg = eps[2 * B + 2 * b + i]  # sample b's negative i, interleaved
                acc[b] += neg_w[b, i] * perpendicular_component(
                    (neg - e_unc[b])[None], e_pos[b][None])[0]
        eps_cfg = e_text + tg.cfg.guidance_scale * (e_pos + acc)
        grad = (1.0 - tg.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1) * (eps_cfg - noise)
        want = 0.5 * float((grad ** 2).sum()) / B
    assert abs(tl - want) <= RTOL * abs(want), (tl, want)
    assert abs(tgn - float(torch.linalg.norm(grad))) <= RTOL * tgn
    # the JAX package pairs sample b with the wrong negative
    assert abs(tl - jl) > 1e-3 * abs(jl), (tl, jl)
