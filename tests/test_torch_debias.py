"""Port parity: BERT-PMI prompt debiasing.

- The WordPiece tokenizer (copied) gives the JAX package's ids for several
  prompts, with the hash vocabulary and with a small ``vocab.txt``.
- The tiny BERT masked LM: the JAX package's parameters through the weight
  bridge (``convert.bert_state_dict_from_flax``) load strictly into the
  port's module, whose keys are the Hugging Face ones; its logits on padded
  batches agree to 1e-5 (absolute; fp32 on the CPU).
- ``get_debiased_prompt`` gives the JAX package's prompts for the bridged
  weights and for a synthetic scorer that makes the PMI rule drop words.
- The prompt processor with ``use_prompt_debiasing``: both packages load
  the same BERT checkpoint (``pytorch_model.bin`` with Hugging Face keys,
  weights at std 1 so that words are dropped) from one directory and give
  the same four direction prompts; manual view prompts are refused.
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
from dreammat_tpu.models import debias as jdebias
from dreammat_tpu.models.diffusion import bert as jbert
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.diffusion.wordpiece import WordPieceTokenizer as JTok
from dreammat_tpu_torch.models import debias as tdebias
from dreammat_tpu_torch.models.diffusion import bert as tbert
from dreammat_tpu_torch.models.diffusion.convert import bert_state_dict_from_flax
from dreammat_tpu_torch.models.diffusion.wordpiece import WordPieceTokenizer as TTok
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

PROMPTS = ["a red apple", "A wooden chair, front-facing and worn", "Crème brûlée in a [MASK] dish",
           "the back of a vintage leather armchair", "an overhead lamp"]


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny BERT (``build_bert_mlm``'s random fill) and the port's
    module holding the same weights."""
    cfg = jbert.BertConfig.tiny()
    model = jbert.BertForMaskedLM(cfg)
    ids0, m0 = jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32)
    params = jconvert.fast_random_init(jax.random.PRNGKey(0),
                                       lambda: model.init(jax.random.PRNGKey(0), ids0, m0))
    tmodel = tbert.BertForMaskedLM(tbert.BertConfig.tiny()).eval()
    sd = bert_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tmodel.load_state_dict(sd, strict=True)
    jfn = jax.jit(lambda ids, mask: model.apply(params, ids, mask))

    @torch.no_grad()
    def tfn(ids, mask):
        return tmodel(torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask))

    return jfn, tfn, sd


def test_wordpiece_ids_match_jax(tmp_path):
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + ["a", "red", "apple", "wood", "##en", "chair", ",", "front", "-", "facing", "and",
           "side", "back", "overhead", "view", "this", "image", "is", "depicting", "of"]) + "\n")
    for vocab_dir in (None, str(tmp_path)):
        for size in (256, 30522):
            jt, tt = JTok.from_dir(vocab_dir, size), TTok.from_dir(vocab_dir, size)
            for p in PROMPTS:
                text = f"This image is depicting a {jt.mask_token} view of {p}"
                assert tt.encode(text, 32) == jt.encode(text, 32), (vocab_dir, p)
            assert tt.tokenize_words(tdebias.VIEWS) == jt.tokenize_words(jdebias.VIEWS)
    vocab = TTok.from_dir(str(tmp_path)).vocab
    assert vocab["[MASK]"] == 103 and vocab["##en"] == 108


def test_tiny_bert_logits_match_jax(tiny_pair):
    jfn, tfn, sd = tiny_pair
    assert set(sd) == set(tbert.BertForMaskedLM(tbert.BertConfig.tiny()).state_dict())
    assert "bert.encoder.layer.1.attention.self.query.weight" in sd
    tok = TTok.from_dir(None, 256)
    enc = [tok.encode(f"This image is depicting a [MASK] view of {p}", 32) for p in PROMPTS]
    ids = np.asarray([e[0] for e in enc], np.int32)
    mask = np.asarray([e[1] for e in enc], np.int32)
    assert mask.min() == 0  # padded
    jl, tl = np.asarray(jfn(ids, mask)), tfn(ids, mask).numpy()
    assert tl.shape == jl.shape == (len(PROMPTS), 32, 256)
    assert np.abs(tl - jl).max() <= 1e-5


def _synthetic_scorer(vocab_size, view_ids, seed=3):
    """Logits at every position: a per-token table summed over the
    sequence, on the four view words only."""
    w = np.random.RandomState(seed).normal(0, 2.0, (vocab_size, 4)).astype(np.float32)

    def fn(ids, mask):
        ids, mask = np.asarray(ids), np.asarray(mask)
        s = (w[ids] * mask[..., None]).sum(1)                       # [B,4]
        out = np.full(ids.shape + (vocab_size,), -5.0, np.float32)
        out[:, :, view_ids] = s[:, None, :]
        return out

    return fn


@pytest.mark.parametrize("scorer", ["bridged", "synthetic"])
def test_debiased_prompts_match_jax(tiny_pair, scorer):
    jfn, tfn, _ = tiny_pair
    jt, tt = JTok.from_dir(None, 256), TTok.from_dir(None, 256)
    if scorer == "synthetic":
        jfn = _synthetic_scorer(256, jt.tokenize_words(jdebias.VIEWS))
        tfn = lambda ids, mask, f=jfn: torch.from_numpy(f(ids, mask))
    dropped = 0
    for p in PROMPTS:
        for mask_ids in (None, [1, 2]):
            jd = jdebias.get_debiased_prompt(p, jfn, jt, mask_ids=mask_ids)
            td = tdebias.get_debiased_prompt(p, tfn, tt, mask_ids=mask_ids)
            assert td == jd, (p, mask_ids)
            dropped += sum(d != p for d in td)
    if scorer == "synthetic":
        assert dropped > 0  # the rule did drop words


def test_prompt_processor_prompts_match_jax(tmp_path, tiny_pair):
    _, _, sd = tiny_pair
    gen = torch.Generator().manual_seed(5)
    heavy = {k: torch.randn(v.shape, generator=gen) if v.dim() > 1 else v
             for k, v in sd.items()}
    torch.save(heavy, tmp_path / "pytorch_model.bin")
    cfg = {"prompt": "a weathered bronze statue of a horse", "model_size": "tiny",
           "use_prompt_debiasing": True, "use_cache": False,
           "pretrained_model_name_or_path_prompt_debiasing": str(tmp_path)}
    jp = dreammat_tpu.find("stable-diffusion-prompt-processor")(cfg)
    tp = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(cfg, device="cpu")
    assert tp.prompts_vd == jp.prompts_vd
    assert any(d != cfg["prompt"] for d in tp.debiased)  # some view lost a word
    with pytest.raises(AssertionError, match="manually assign"):
        dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(
            dict(cfg, prompt_side="a horse, side"), device="cpu")
