"""optax's Adagrad (scale_by_rss: the accumulator starts at 0.1, eps 1e-7
inside the rsqrt), times -learning_rate."""
from __future__ import annotations

import torch


def init(params, training):
    return {"acc": {k: torch.full_like(v, 0.1) for k, v in params.items()}}


def update(grads, state, training):
    lr = training["learning_rate"]
    acc = {k: state["acc"][k] + g * g for k, g in grads.items()}
    ups = {k: -lr * torch.where(acc[k] > 0, torch.rsqrt(acc[k] + 1e-7), 0.0) * g
           for k, g in grads.items()}
    return ups, {"acc": acc}
