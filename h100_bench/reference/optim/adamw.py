"""optax's AdamW (scale_by_adam: b1 0.9, b2 0.999, eps 1e-8 outside the
sqrt, both moments debiased; add_decayed_weights: weight_decay x params
added to the update before the learning rate), times -learning_rate.

The rule reads the params, which ``train.follow`` does not hand an
optimizer: the state keeps its own copy, advanced by each update it
returns (follow applies every update it asks for, and asks for none on a
skipped step)."""
from __future__ import annotations

import torch


def init(params, training):
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "params": {k: v.clone() for k, v in params.items()}}


def update(grads, state, training):
    lr, wd = training["learning_rate"], training["weight_decay"]
    count = state["count"] + 1
    mu = {k: 0.1 * g + 0.9 * state["mu"][k] for k, g in grads.items()}
    nu = {k: 0.001 * g * g + 0.999 * state["nu"][k] for k, g in grads.items()}
    c1, c2 = 1 - 0.9 ** count, 1 - 0.999 ** count
    ups = {k: -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8) + wd * state["params"][k])
           for k in grads}
    params = {k: (state["params"][k] + ups[k]).detach() for k in grads}
    return ups, {"count": count, "mu": mu, "nu": nu, "params": params}
