"""Optimizer construction from the config block (name + args), as
``dreammat_tpu/systems/optimizers.py::parse_optimizer`` does with optax.
Adam / AdamW are ported; Adan and SGD are not yet."""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch


def parse_optimizer(cfg: Dict[str, Any], params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    name = cfg.get("name", "Adam")
    args = dict(cfg.get("args", {}))
    lr = args.pop("lr", 1e-3)
    betas = tuple(args.pop("betas", (0.9, 0.999)))
    eps = args.pop("eps", 1e-8)
    weight_decay = args.pop("weight_decay", 0.0)
    if name.lower() in ("adam", "adamw"):
        if weight_decay:
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    raise NotImplementedError(f"optimizer '{name}' is not ported yet (Adam/AdamW only)")
