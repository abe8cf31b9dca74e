"""optax's Adamax (scale_by_adamax: b1 0.9, b2 0.999, eps 1e-8, the first
moment debiased), times -learning_rate."""
from __future__ import annotations

import torch


def init(params, training):
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def update(grads, state, training):
    lr = training["learning_rate"]
    count = state["count"] + 1
    mu = {k: 0.1 * g + 0.9 * state["mu"][k] for k, g in grads.items()}
    nu = {k: torch.maximum(g.abs() + 1e-8, 0.999 * state["nu"][k]) for k, g in grads.items()}
    c1 = 1 - 0.9 ** count
    ups = {k: -lr * (mu[k] / c1) / nu[k] for k in grads}
    return ups, {"count": count, "mu": mu, "nu": nu}
