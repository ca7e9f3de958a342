"""BERT-PMI view-prompt debiasing.

Counterpart of ``dreammat_tpu/models/debias.py``: a masked LM scores
"This image is depicting a [MASK] view of {prompt}" over the four view
words (side, front, back, overhead), for the whole prompt and for the
prompt without each candidate word. A word is dropped from view v's prompt
when its removal moves the view distribution against v:

    pmi = full / lerp(part, full, 0.5);   drop the word for view i iff pmi[i] < 0.95

``build_bert_mlm`` makes the scorer: the port's ``BertForMaskedLM`` with
random weights from an explicit ``torch.Generator`` unless ``model_dir``
holds a checkpoint (``model.safetensors``, ``pytorch_model.bin``, ...,
Hugging Face keys), and the WordPiece tokenizer of ``model_dir/vocab.txt``
or the hash vocabulary.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.wordpiece import WordPieceTokenizer
from dreammat_tpu_torch.utils.hw import resolve_device

VIEWS = ["side", "front", "back", "overhead"]


def build_bert_mlm(model_dir: Optional[str], size: str = "base", device="cuda",
                   generator: Optional[torch.Generator] = None):
    """(mlm_fn, tokenizer, model): ``mlm_fn(ids [B,N], mask [B,N]) -> logits
    [B,N,vocab]`` on ``device``; BERT-base for ``size="base"``, the tiny
    test size otherwise."""
    from dreammat_tpu_torch.models.diffusion import convert
    from dreammat_tpu_torch.models.diffusion.bert import BertConfig, BertForMaskedLM

    device = resolve_device(device)
    cfg = BertConfig.base_uncased() if size == "base" else BertConfig.tiny()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = convert.build_on(lambda: BertForMaskedLM(cfg), device, torch.float32)
    model = convert.random_init_(model, generator).eval().requires_grad_(False)
    tokenizer = WordPieceTokenizer.from_dir(model_dir, vocab_size=cfg.vocab_size)
    if model_dir and os.path.isdir(str(model_dir)):
        ckpt = convert.find_checkpoint_file(str(model_dir))
        if ckpt:
            sd = dict(convert.load_state_dict_file(ckpt))
            if "cls.predictions.decoder.weight" not in sd:  # tied to the word embeddings
                sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
            convert.load_diffusers_weights(model, sd, "bert", source=ckpt)

    @torch.no_grad()
    def mlm_fn(ids, mask):
        as_ids = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
        return model(as_ids(ids), as_ids(mask))

    return mlm_fn, tokenizer, model


def get_debiased_prompt(prompt: str, mlm_fn: Callable, tokenizer: WordPieceTokenizer,
                        mask_ids: Optional[List[int]] = None, max_length: int = 32,
                        threshold: float = 0.95) -> List[str]:
    """One debiased base prompt per view direction (side, front, back,
    overhead)."""
    view_ids = tokenizer.tokenize_words(VIEWS)

    def modulate(p: str) -> torch.Tensor:
        text = f"This image is depicting a {tokenizer.mask_token} view of {p}"
        ids, mask = tokenizer.encode(text, max_length=max_length)
        logits = mlm_fn([ids], [mask])
        mask_pos = ids.index(tokenizer.mask_token_id)
        probs = torch.softmax(logits[0, mask_pos].float(), dim=-1)[view_ids]
        return (probs / torch.sum(probs)).cpu()

    words = prompt.split(" ")
    prompts = [list(words) for _ in VIEWS]
    full_probe = modulate(prompt)
    ids_to_mask = mask_ids if mask_ids is not None else list(range(len(words)))
    dreammat_tpu_torch.info("Words that can potentially be removed: %s",
                            [words[i] for i in ids_to_mask])
    for idx in ids_to_mask:
        part_probe = modulate(" ".join(words[:idx] + words[idx + 1:]))
        pmi = full_probe / (0.5 * (part_probe + full_probe))
        for i in range(len(VIEWS)):
            if float(pmi[i]) < threshold:
                prompts[i][idx] = ""
    debiased = [" ".join(w for w in p if w) for p in prompts]
    for v, dp in zip(VIEWS, debiased):
        dreammat_tpu_torch.info("Debiased prompt of the %s view is [%s]", v, dp)
    return debiased
