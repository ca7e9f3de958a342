"""Optimizer and scheduler construction from the config block (name + args).

Counterpart of ``dreammat_tpu/systems/optimizers.py``: ``parse_optimizer``
gives Adam / AdamW, SGD (with momentum) and Adan; ``parse_scheduler`` gives
``ExponentialLR`` and ``LinearLR`` (to 0 over ``total_iters``). ``Adan`` is
the JAX package's update as written there: the three moment EMAs, the
bias corrections bc1..bc3, ``b2 * v / bc2`` in the numerator and the
weight decay added to the step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch


class Adan(torch.optim.Optimizer):
    """Adan (Adaptive Nesterov Momentum), betas as decay rates:

        diff = g - g_prev (0 at the first step)
        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) diff
        n = b3 n + (1 - b3) (g + b2 diff)^2
        p -= lr ((m / bc1 + b2 v / bc2) / (sqrt(n / bc3) + eps) + wd p)

    with bc_i = 1 - b_i^step."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.98, 0.92, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("m", "v", "n", "prev_grad"):
                        st[k] = torch.zeros_like(p)
                st["step"] += 1
                c = st["step"]
                diff = g - st["prev_grad"] if c > 1 else torch.zeros_like(g)
                m, v, n = st["m"], st["v"], st["n"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(diff, alpha=1 - b2)
                n.mul_(b3).add_((g + b2 * diff) ** 2, alpha=1 - b3)
                bc1, bc2, bc3 = 1 - b1 ** c, 1 - b2 ** c, 1 - b3 ** c
                upd = (m / bc1 + b2 * v / bc2) / (torch.sqrt(n / bc3) + eps) + wd * p
                p.add_(upd, alpha=-lr)
                st["prev_grad"].copy_(g)
        return loss


def parse_optimizer(cfg: Dict[str, Any], params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    name = cfg.get("name", "Adam")
    args = dict(cfg.get("args", {}))
    lr = args.pop("lr", 1e-3)
    betas = tuple(args.pop("betas", (0.9, 0.999)))
    eps = args.pop("eps", 1e-8)
    weight_decay = args.pop("weight_decay", 0.0)
    name_l = name.lower()
    if name_l in ("adam", "adamw"):
        if weight_decay:
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if name_l == "adan":
        # b3 stays at its default, as in the JAX package
        return Adan(params, lr=lr, betas=(betas[0] if betas else 0.98,
                                          betas[1] if len(betas) > 1 else 0.92, 0.99),
                    eps=eps, weight_decay=weight_decay)
    if name_l == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=args.pop("momentum", 0.0))
    raise ValueError(f"unknown optimizer '{name}'")


def parse_scheduler(cfg: Optional[Dict[str, Any]], optimizer: torch.optim.Optimizer):
    """``ExponentialLR`` (``gamma``, default 0.99) or ``LinearLR`` from the
    base lr to 0 over ``total_iters`` (default 1000) on ``optimizer``; None
    without a config."""
    if not cfg:
        return None
    name = cfg.get("name", "").lower()
    args = cfg.get("args", {})
    if name == "exponentiallr":
        return torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma=args.get("gamma", 0.99))
    if name == "linearlr":
        return torch.optim.lr_scheduler.LinearLR(optimizer, start_factor=1.0, end_factor=0.0,
                                                 total_iters=args.get("total_iters", 1000))
    raise ValueError(f"unknown scheduler '{name}'")
