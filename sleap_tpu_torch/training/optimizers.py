"""The trainer's optimizers, with optax's update rules.

``adam`` is :class:`torch.optim.Adam` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8 added outside the square root): the same rule. ``amsgrad``
is :class:`AMSGrad` below, because optax and :class:`torch.optim.Adam`
(``amsgrad=True``) differ: optax keeps the running maximum of the
*bias-corrected* second moment, torch the maximum of the raw moment, which
it then corrects. The learning rate lives in ``param_groups``, where the
trainer's schedule sets it.
"""

from __future__ import annotations

from typing import Iterable

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


class AMSGrad(torch.optim.Optimizer):
    """optax's ``scale_by_amsgrad`` then ``scale(-lr)``: with
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2`` and step count t,
    ``v_max = max(v_max, v / (1 - b2^t))`` and
    ``p -= lr (m / (1 - b1^t)) / (sqrt(v_max) + eps)``."""

    def __init__(self, params: Iterable, lr: float = 1e-3, betas=BETAS, eps: float = EPS):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    state["nu_max"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                g = p.grad
                state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                torch.maximum(state["nu_max"], state["nu"] / (1 - b2**t), out=state["nu_max"])
                update = (state["mu"] / (1 - b1**t)) / (state["nu_max"].sqrt() + group["eps"])
                p.add_(update, alpha=-group["lr"])
        return loss


def make_optimizer(name: str, params: Iterable, lr: float) -> torch.optim.Optimizer:
    """``"adam"`` or ``"amsgrad"`` at learning rate ``lr``."""
    if name == "amsgrad":
        return AMSGrad(params, lr=lr)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)
    raise ValueError(f"Unknown optimizer {name!r}.")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
