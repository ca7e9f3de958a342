"""Port parity: the prompt side, from ``lib:`` prompts to Perp-Neg guidance.

- ``lib:`` prompts resolve through a prompt library JSON written here to
  the same text in both packages; an unknown key raises in both.
- The embedding cache: the md5 keys are equal, ``.npy`` files written by
  the JAX package are read by the port (no encoding), and files written by
  the port are read by the JAX package (its encoder made to raise).
- ``get_text_embeddings_perp_neg``: the embeddings and the negatives'
  weights at elevations and azimuths over every bucket and its borders,
  overhead included, to 1e-6.
- The Perp-Neg guidance (five replicas in one ControlNet + UNet pass, the
  negatives interleaved per sample, each on its own sample's latent,
  ``perpneg_scale`` in the gradient) on the tiny diffusion stack at batch
  2, with the JAX package's draws handed to the port and its weights
  carried over by the weight bridge: the port's loss is the formula by
  hand on its own rows; the JAX package's loss and image gradient are the
  formula on block-replicated latents (its fault at B > 1), to relative
  2e-3.
"""

import json
import os

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
from dreammat_tpu_torch.models.prompt import PromptEmbeddings as TPE
from test_torch_dreammat_step import _numpy_random_init as shared_numpy_init
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


LIBRARY = {"dreamfusion": {"a_hamburger": "a delicious hamburger", "vase": "a blue vase"},
           "materials": {"vase": "a ceramic vase with a glossy glaze"}, "version": 3}


def _processors(cfg):
    return (dreammat_tpu.find("stable-diffusion-prompt-processor")(cfg),
            dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(cfg, device="cpu"))


def test_lib_prompts_resolve_as_in_jax(tmp_path):
    lib = tmp_path / "prompt_library.json"
    lib.write_text(json.dumps(LIBRARY))
    cfg = {"model_size": "tiny", "use_cache": False, "prompt": "lib:vase",
           "prompt_library_path": str(lib)}
    jp, tp = _processors(cfg)
    assert tp.prompt == jp.prompt == "a blue vase"
    assert tp.prompts_vd == jp.prompts_vd
    for p in ("lib:a_hamburger", "plain words"):
        assert tp.preprocess_prompt(p) == jp.preprocess_prompt(p)
    for proc in (jp, tp):
        with pytest.raises(ValueError, match="not found"):
            proc.preprocess_prompt("lib:absent")


PROMPTS = ["a red apple", "", "a red apple, side view", "ugly"]


def test_embedding_cache_written_by_jax_is_read_by_the_port(tmp_path):
    cfg = {"model_size": "tiny", "use_cache": True, "cache_dir": str(tmp_path),
           "prompt": "a red apple"}
    jp, tp = _processors(cfg)
    assert [tp._cache_key(p) for p in PROMPTS] == [jp._cache_key(p) for p in PROMPTS]
    ref = jp.encode_prompts(PROMPTS)
    assert sorted(os.listdir(tmp_path)) == sorted(jp._cache_key(p) + ".npy" for p in PROMPTS)

    def no_encoder(*a, **k):
        raise AssertionError("the port encoded instead of reading the cache")

    tp._encode_uncached = no_encoder
    got = tp.encode_prompts(PROMPTS)
    assert tp.cache_hits == len(PROMPTS)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)


def test_embedding_cache_written_by_the_port_is_read_by_jax(tmp_path):
    cfg = {"model_size": "tiny", "use_cache": True, "cache_dir": str(tmp_path),
           "prompt": "a red apple"}
    jp, tp = _processors(cfg)
    ref = tp.encode_prompts(PROMPTS).numpy()
    assert tp.cache_hits == 0
    assert sorted(os.listdir(tmp_path)) == sorted(tp._cache_key(p) + ".npy" for p in PROMPTS)

    def no_encoder(*a, **k):
        raise AssertionError("the JAX package encoded instead of reading the cache")

    jp._encode_uncached = no_encoder
    got = jp.encode_prompts(PROMPTS)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    # and the port itself reads them back on the next start
    tp2 = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(cfg, device="cpu")
    assert np.array_equal(tp2.encode_prompts(PROMPTS).numpy(), ref)
    assert tp2.cache_hits == len(PROMPTS) and tp2.text_encoder is None


def _embeddings(N=6, D=8, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"text_vd": (4, N, D), "uncond_vd": (4, N, D), "text": (N, D), "uncond": (N, D),
              "null": (N, D)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


# (elevation, azimuth): front, side, back, the bucket borders, both signs,
# azimuths outside [-180, 180), and overhead views
VIEWS = [(0, 0), (10, 30), (-5, 45), (20, 60), (0, 89.9), (0, 90), (15, 120), (0, 135),
         (30, 179), (0, 180), (0, -180), (5, -30), (-20, -95), (10, -170), (0, 270),
         (0, -400), (61, 20), (75, -150), (60, 10), (89, 90)]


def test_perp_neg_embeddings_and_weights_match_jax():
    emb = _embeddings()
    je = JPE(**{k: jnp.asarray(v) for k, v in emb.items()}, use_perp_neg=True)
    te = TPE(**{k: torch.from_numpy(v) for k, v in emb.items()}, use_perp_neg=True)
    elev = np.array([e for e, _ in VIEWS], np.float32)
    azim = np.array([a for _, a in VIEWS], np.float32)
    dist = np.full_like(elev, 3.5)
    j_emb, j_w = je.get_text_embeddings_perp_neg(jnp.asarray(elev), jnp.asarray(azim),
                                                 jnp.asarray(dist))
    t_emb, t_w = te.get_text_embeddings_perp_neg(torch.from_numpy(elev), torch.from_numpy(azim),
                                                 torch.from_numpy(dist))
    assert t_emb.shape == (5 * len(VIEWS), 6, 8) and t_w.shape == (len(VIEWS), 2)
    assert np.abs(t_emb.numpy() - np.asarray(j_emb)).max() <= 1e-6
    assert np.abs(t_w.numpy() - np.asarray(j_w)).max() <= 1e-6
    over = elev > 60
    assert np.all(t_w.numpy()[over] == 0) and np.all(t_w.numpy()[~over] != 0)


def _numpy_random_init(rng, init_fn):
    """``fast_random_init``'s fill (normal(0, 0.05), norm scales 1, biases 0) from numpy, seeded
    from the key (``test_torch_dreammat_step._numpy_random_init`` at this std)."""
    return shared_numpy_init(rng, init_fn, std=0.05)


class GivenDraws:
    def __init__(self, draws):
        self.draws = draws

    def uniform(self, name, shape):
        assert tuple(self.draws[name].shape) == tuple(shape), name
        return torch.from_numpy(np.array(self.draws[name]))

    normal = uniform


def test_perp_neg_guidance_matches_jax():
    """At batch 2 the port runs each negative on its own sample's latent
    (``perp_neg_rows``); the JAX package replicates the latents in blocks,
    so its sample 1's negatives run on sample 0's latent and the reverse.
    The port's loss is the formula by hand on its own rows, and the JAX
    package's loss and image gradient are the same formula on the block
    rows (to relative 2e-3); the two differ by a share of the Perp-Neg
    term."""
    from dreammat_tpu_torch.models.diffusion.scheduler import add_noise
    from dreammat_tpu_torch.models.guidance import perp_neg_rows
    from dreammat_tpu_torch.utils.ops import perpendicular_component

    cfg = {"model_size": "tiny", "half_precision_weights": False, "width": 32, "height": 32,
           "cache_dir": None, "controlnet_path": None, "cond_scale": 1.0,
           "uncond_scale": -0.5, "null_scale": -1.0, "perpneg_scale": 0.7, "noise_scale": 0.0}
    jg = dreammat_tpu.find("stable-diffusion-dreammat-guidance")(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find("stable-diffusion-dreammat-guidance")(cfg, device="cpu")
    tg.init_params()
    gp = jax.tree_util.tree_map(np.asarray, jg.params)
    tg.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    tg.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    tg.controlnets[0].load_state_dict(flax_to_torch_state_dict(gp["controlnets"][0],
                                                               "controlnet"), strict=True)

    emb = _embeddings(N=16, D=64, seed=1)
    je = JPE(**{k: jnp.asarray(v) for k, v in emb.items()}, use_perp_neg=True)
    te = TPE(**{k: torch.from_numpy(v) for k, v in emb.items()}, use_perp_neg=True)
    B = 2
    rng = np.random.RandomState(3)
    rgb = rng.uniform(size=(B, 32, 32, 3)).astype(np.float32)
    cond = rng.uniform(size=(B, 16, 16, 22)).astype(np.float32)
    elev, azim = np.float32([10.0, 30.0]), np.float32([40.0, -120.0])
    dist = np.float32([3.5, 3.5])
    key, step = jax.random.PRNGKey(5), 100

    def jloss(x):
        out = jg(jg.params, x, je, jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist),
                 jnp.asarray(cond), jnp.int32(step), key)
        return out["loss_sds"]

    j_loss, j_grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(rgb))

    k_enc, k_t, k_noise = jax.random.split(key, 3)
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    lat = (B, 16, 16, 4)
    draws = GivenDraws({"vae_eps": nchw(jax.random.normal(k_enc, lat)),
                        "t": np.asarray(jax.random.uniform(k_t, (B,))),
                        "noise": nchw(jax.random.normal(k_noise, lat))})
    x = torch.from_numpy(nchw(rgb)).requires_grad_()
    args = (te, torch.from_numpy(elev), torch.from_numpy(azim), torch.from_numpy(dist),
            torch.from_numpy(nchw(cond)), step, draws)
    out = tg(x, *args)
    out["loss_sds"].backward()
    t_loss = out["loss_sds"].item()

    # the loss by hand, on the port's rows and on the JAX package's blocks
    z = x.detach().requires_grad_()
    latents = tg.encode_images(z, torch.from_numpy(draws.draws["vae_eps"]))
    t, _, _ = tg._timesteps(B, step, draws)
    noise = torch.from_numpy(draws.draws["noise"])
    emb5, neg_w = te.get_text_embeddings_perp_neg(*args[1:4])
    image_cond, scales = tg._controls(args[4], z, step)

    def by_hand(rows, perpneg_scale):
        with torch.no_grad():
            eps = tg.noise_pred(add_noise(tg.schedule, latents, noise, t), t, emb5, image_cond,
                                scales, 5, rows=rows)
        e_text, e_unc, e_neg, e_null = eps[:B], eps[B:2 * B], eps[2 * B:4 * B], eps[4 * B:]
        e_pos = e_text - e_unc
        perp = sum(neg_w[:, i].reshape(-1, 1, 1, 1)
                   * perpendicular_component(e_neg[i::2] - e_unc, e_pos) for i in range(2))
        w = (1.0 - tg.schedule["alphas_cumprod"][t]).reshape(-1, 1, 1, 1)
        grad = w * (e_text - 0.5 * e_unc - e_null + perpneg_scale * perp)
        return 0.5 * torch.sum((latents - (latents - grad).detach()) ** 2) / B

    own = by_hand(perp_neg_rows(B, True, t.device), 0.7)
    assert abs(own.item() - t_loss) <= 1e-5 * t_loss, (own.item(), t_loss)
    blocks = by_hand(None, 0.7)
    blocks.backward()
    assert abs(blocks.item() - float(j_loss)) <= 2e-3 * abs(float(j_loss))
    assert _rel(z.grad.permute(0, 2, 3, 1).numpy(), j_grad) < 2e-3
    # the Perp-Neg term is in the port's loss, and the JAX block read moves it
    no_perp = by_hand(None, 0.0).item()
    assert abs(t_loss - no_perp) > 1e-3 * t_loss
    assert abs(t_loss - float(j_loss)) > 0.05 * abs(t_loss - no_perp), (t_loss, float(j_loss))
    assert np.abs(x.grad.numpy()).max() > 0
