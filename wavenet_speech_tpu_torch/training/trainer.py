"""Train state and the joint train and eval steps
(wavenet_speech_tpu/training/trainer.py).

The step is functional, as in JAX: ``step_fn(state, batch) -> (state,
metrics)``. Params are a tree ``{"base": {name: tensor}, "ctc": {name:
tensor}}`` keyed as the modules' state dicts (``param_tree``), and the
modules run on them through ``torch.func.functional_call``. Nothing in the
step reads a value back to the host: the skip guard selects with
``torch.where`` on the device.

On the card the causal blocks run their forward and backward kernels (B4,
B5) and the CTC its alpha and beta kernels (B1, B2); on the CPU the same
step runs their plain versions.

Not ported yet: ``compute_dtype`` other than None (the bf16 variants of B4
and B5, ROADMAP B), ``make_ctc_train_step`` (with RawCTCNet, ROADMAP A8),
and the JAX options ``donate`` and ``scan_unroll``, which have no meaning
in an eager loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from wavenet_speech_tpu_torch.training.loss import JointLoss
from wavenet_speech_tpu_torch.training.optimizer import (GradientTransformation,
                                                         apply_updates)
from wavenet_speech_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                                 tree_unflatten)

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Params tree, optimizer state, and the step count (int32 scalar)."""

    params: Any
    opt_state: Any
    step: torch.Tensor

    @classmethod
    def create(cls, params, tx: GradientTransformation) -> "TrainState":
        device = tree_leaves(params)[0].device
        return cls(params=params, opt_state=tx.init(params),
                   step=torch.zeros((), dtype=torch.int32, device=device))


def param_tree(base_model: nn.Module, ctc_model: nn.Module):
    """The params of a (WaveNet, WaveNetClassifier) pair as the step's tree,
    copied off the modules: {"base": {name: tensor}, "ctc": {...}}."""
    return {"base": {k: v.detach().clone() for k, v in base_model.state_dict().items()},
            "ctc": {k: v.detach().clone() for k, v in ctc_model.state_dict().items()}}


def all_finite(tree) -> torch.Tensor:
    """True iff every element of every leaf is finite (trainer.py:50-61).
    The skip guard's predicate: the finiteness of a naive global norm is
    false on finite gradients past ~1.8e19, whose squares overflow f32."""
    return torch.stack([torch.isfinite(l).all() for l in tree_leaves(tree)]).all()


def global_norm_safe(tree) -> torch.Tensor:
    """Overflow-proof global L2 norm (trainer.py:64-73): the leaves are
    scaled by the global absmax before squaring. 0 for an all-zero tree, NaN
    for a tree holding an inf, and 0 for one holding a NaN, as in JAX (whose
    docstring says non-finite; the skip guard reads all_finite, not this)."""
    leaves = tree_leaves(tree)
    absmax = torch.stack([l.abs().max() for l in leaves]).max()
    scale = torch.clamp(absmax, min=torch.finfo(torch.float32).tiny)
    ssq = sum(torch.sum((l / scale) ** 2) for l in leaves)
    return torch.where(absmax > 0, scale * torch.sqrt(ssq), 0.0)


def _batch_to(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _forward_losses(base_model, ctc_model, loss: JointLoss, params, batch,
                    logit_length_fn):
    """(total, xe, ctc) of the joint objective (trainer.py:127-163)."""
    signal = batch["signal"]
    if signal.dim() == 2:
        # quantised levels shipped from the host: one-hot on the device
        signal = nn.functional.one_hot(signal.long(), base_model.in_dim).float()
    signal_pred = functional_call(base_model, params["base"], (signal,))
    # the classifier reads the WaveNet's output, as in inference
    logits = functional_call(ctc_model, params["ctc"], (signal_pred,))
    kwargs = {}
    if logit_length_fn is not None:  # length-aware mode
        kwargs = {"logit_lengths": logit_length_fn(batch["signal_lengths"]),
                  "signal_lengths": batch["signal_lengths"]}
    xe, ctc = loss.calculate(signal, signal_pred, logits, batch["labels"],
                             batch["label_lengths"], **kwargs)
    total = ctc if xe is None else loss.joint_weight * xe + loss.ctc_weight * ctc
    return total, (torch.zeros((), device=ctc.device) if xe is None else xe), ctc


def _no_bf16_yet(compute_dtype):
    if compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype must be None: the bf16 variants of the fused block "
            "kernels (B4, B5) are not ported yet (ROADMAP B)")


def make_joint_train_step(base_model: nn.Module, ctc_model: nn.Module,
                          tx: GradientTransformation,
                          loss: Optional[JointLoss] = None,
                          compute_dtype=None,
                          logit_length_fn: Optional[Callable] = None,
                          steps_per_call: int = 1,
                          multi_same_batch: bool = False):
    """The joint (XE + CTC) step over a {"base", "ctc"} params tree
    (trainer.py:103-196). batch: a dict of "signal" ((B, L, C) one-hot or
    (B, L) levels), "labels", "label_lengths" and, for logit_length_fn
    (signal lengths -> logit lengths, the length-aware mode),
    "signal_lengths"; arrays or tensors, moved to the params' device.

    A step whose loss or gradients hold a non-finite value is skipped:
    params and optimizer state carry through unchanged, the step count
    still advances, and ``skipped_nonfinite`` is 1.

    steps_per_call=K runs K steps a call: on the same batch with
    multi_same_batch, else on K batches stacked on a leading axis; the
    metrics then come back stacked (K,).

    Returns step_fn(state, batch) -> (state, metrics)."""
    _no_bf16_yet(compute_dtype)
    loss = loss or JointLoss("joint")

    def step_fn(state: TrainState, batch) -> tuple:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        total, xe, ctc = _forward_losses(base_model, ctc_model, loss, params, batch,
                                         logit_length_fn)
        # the last block's residual projection reaches no output: zero grads
        grads = tree_unflatten(state.params, list(torch.autograd.grad(
            total, leaves, allow_unused=True, materialize_grads=True)))
        # the skip guard (trainer.py:168-182): all_finite and global_norm_safe,
        # not the finiteness of a naive norm, which overflows f32 on finite
        # gradients past ~1.8e19 and would freeze training
        gnorm = global_norm_safe(grads)
        ok = torch.isfinite(total) & all_finite(grads)
        grads = tree_map(lambda g: torch.where(ok, g, 0.0), grads)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        updates = tree_map(lambda u: torch.where(ok, u, 0.0), updates)
        opt_state = tree_map(lambda n, o: torch.where(ok, n, o), new_opt_state,
                             state.opt_state)
        new_params = apply_updates(state.params, updates)
        metrics = {"xe_loss": xe.detach(), "ctc_loss": ctc.detach(),
                   "total_loss": total.detach(), "grad_norm": gnorm,
                   "skipped_nonfinite": (~ok).to(torch.int32)}
        return TrainState(new_params, opt_state, state.step + 1), metrics

    def run(state: TrainState, batch):
        batch = _batch_to(batch, tree_leaves(state.params)[0].device)
        if steps_per_call == 1:
            return step_fn(state, batch)
        history = []
        for i in range(steps_per_call):
            state, m = step_fn(state, batch if multi_same_batch
                               else {k: v[i] for k, v in batch.items()})
            history.append(m)
        return state, {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return run


def make_eval_step(base_model: nn.Module, ctc_model: nn.Module,
                   loss: Optional[JointLoss] = None, compute_dtype=None,
                   logit_length_fn: Optional[Callable] = None):
    """The validation step (trainer.py:277-306): the train step's metrics
    and weighting, no update. Returns eval_fn(params, batch) -> metrics."""
    _no_bf16_yet(compute_dtype)
    loss = loss or JointLoss("joint")

    def eval_fn(params, batch) -> Metrics:
        batch = _batch_to(batch, tree_leaves(params)[0].device)
        with torch.no_grad():
            total, xe, ctc = _forward_losses(base_model, ctc_model, loss, params,
                                             batch, logit_length_fn)
        return {"xe_loss": xe, "ctc_loss": ctc, "total_loss": total}

    return eval_fn
