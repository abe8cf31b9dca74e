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

``compute_dtype=torch.bfloat16`` is the JAX package's mixed precision
(trainer.py:42-47, 138-145): the params and the one-hot signal are cast to
bf16 inside the differentiated function, so the models run in bf16 (the
causal blocks on the bf16 forms of B4 and B5) and the gradients reach the
float32 master params through the cast; the losses are computed in float32
(``training/loss.py``, ``ops/ctc.py``), and the optimizer state stays
float32.

With a mesh (``parallel.make_mesh``; the JAX step jitted on sharded
inputs, __graft_entry__.py:110-136, 213-234) each rank's step takes its
(data, seq) shard of the batch (``parallel.shard_batch(mesh, batch,
seq_keys=("signal",))``): under SP the models run with a halo exchange at
every conv and the CTC sequence-sharded, and the loss terms are the global
ones whose gradients are this rank's shares (``training/loss.py``). The
param gradients are summed over every rank (one all-reduce of one flat
buffer) before the skip guard, so the guard, the norm and the optimizer
run on the same values on every rank: all ranks skip together and their
params stay identical.

Not ported yet: training RawCTCNet (``make_ctc_train_step``, BatchNorm's
``update_state``, ROADMAP A8: both steps refuse a module that carries
``not_trainable``, as the raw-ctcnet pair's BatchNorm1d does),
tensor parallelism (a mesh whose "model" axis is > 1 raises), and the JAX
options ``donate`` and ``scan_unroll``, which have no meaning in an eager
loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from wavenet_speech_tpu_torch.parallel.collectives import all_reduce_sum
from wavenet_speech_tpu_torch.parallel.halo import seq_axis
from wavenet_speech_tpu_torch.parallel.mesh import Mesh
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


def _cast(tree, dtype):
    """Floating leaves cast to dtype (trainer.py:42-47); None leaves the
    tree as it is."""
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _check_trainable(*models: nn.Module) -> None:
    """Refuse a model whose training is not ported (its ``not_trainable``
    says why)."""
    for m in models:
        why = getattr(m, "not_trainable", None)
        if why:
            raise NotImplementedError(why)


def _check_mesh(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.axis_size("model") > 1:
        raise NotImplementedError("tensor parallelism over the 'model' axis is not "
                                  "ported (ROADMAP A12)")


def _sharded(mesh: Optional[Mesh]):
    """The SP context where the mesh shards time, else nothing."""
    if mesh is not None and mesh.axis_size("seq") > 1:
        return seq_axis(mesh)
    return contextlib.nullcontext()


def all_reduce_grads(grads, mesh: Optional[Mesh]):
    """The gradient tree summed over every rank of the mesh, by one
    all-reduce of one flat buffer."""
    if mesh is None or mesh.size == 1:
        return grads
    leaves = tree_leaves(grads)
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in leaves]), mesh)
    parts = torch.split(flat, [g.numel() for g in leaves])
    return tree_unflatten(grads, [p.view_as(g) for p, g in zip(parts, leaves)])


def _forward_losses(base_model, ctc_model, loss: JointLoss, params, batch,
                    logit_length_fn, compute_dtype, mesh: Optional[Mesh] = None):
    """(total, xe, ctc) of the joint objective (trainer.py:127-163), the
    models run in compute_dtype (None: the params' own); with a mesh, on
    this rank's shard with the global terms (``training/loss.py``)."""
    signal = batch["signal"]
    if signal.dim() == 2:
        # quantised levels shipped from the host: one-hot on the device
        signal = nn.functional.one_hot(signal.long(), base_model.in_dim).float()
    signal = _cast(signal, compute_dtype)
    params = _cast(params, compute_dtype)
    with _sharded(mesh):
        signal_pred = functional_call(base_model, params["base"], (signal,))
        # the classifier reads the WaveNet's output, as in inference
        logits = functional_call(ctc_model, params["ctc"], (signal_pred,))
    kwargs = {} if mesh is None else {"mesh": mesh}
    if logit_length_fn is not None:  # length-aware mode
        kwargs.update(logit_lengths=logit_length_fn(batch["signal_lengths"]),
                      signal_lengths=batch["signal_lengths"])
    xe, ctc = loss.calculate(signal, signal_pred, logits, batch["labels"],
                             batch["label_lengths"], **kwargs)
    total = ctc if xe is None else loss.joint_weight * xe + loss.ctc_weight * ctc
    return total, (torch.zeros((), device=ctc.device) if xe is None else xe), ctc


def make_joint_train_step(base_model: nn.Module, ctc_model: nn.Module,
                          tx: GradientTransformation,
                          loss: Optional[JointLoss] = None,
                          compute_dtype=None,
                          logit_length_fn: Optional[Callable] = None,
                          steps_per_call: int = 1,
                          multi_same_batch: bool = False,
                          mesh: Optional[Mesh] = None):
    """The joint (XE + CTC) step over a {"base", "ctc"} params tree
    (trainer.py:103-196). batch: a dict of "signal" ((B, L, C) one-hot or
    (B, L) levels), "labels", "label_lengths" and, for logit_length_fn
    (signal lengths -> logit lengths, the length-aware mode),
    "signal_lengths"; arrays or tensors, moved to the params' device.

    compute_dtype: None (the params' float32) or torch.bfloat16, the JAX
    package's mixed precision (see the module docstring).

    A step whose loss or gradients hold a non-finite value is skipped:
    params and optimizer state carry through unchanged, the step count
    still advances, and ``skipped_nonfinite`` is 1.

    steps_per_call=K runs K steps a call: on the same batch with
    multi_same_batch, else on K batches stacked on a leading axis; the
    metrics then come back stacked (K,).

    mesh: run as one rank of a DP/SP mesh, on this rank's shard of each
    batch, the gradients summed over every rank (see the module
    docstring); every rank must call the step with its shard.

    Returns step_fn(state, batch) -> (state, metrics)."""
    loss = loss or JointLoss("joint")
    _check_trainable(base_model, ctc_model)
    _check_mesh(mesh)

    def step_fn(state: TrainState, batch) -> tuple:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        total, xe, ctc = _forward_losses(base_model, ctc_model, loss, params, batch,
                                         logit_length_fn, compute_dtype, mesh)
        # the last block's residual projection reaches no output: zero grads
        grads = all_reduce_grads(tree_unflatten(state.params, list(torch.autograd.grad(
            total, leaves, allow_unused=True, materialize_grads=True))), mesh)
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
                   logit_length_fn: Optional[Callable] = None,
                   mesh: Optional[Mesh] = None):
    """The validation step (trainer.py:277-306): the train step's metrics
    and weighting, no update, in compute_dtype as the train step; with a
    mesh, on this rank's shard, the global metrics on every rank. Returns
    eval_fn(params, batch) -> metrics."""
    loss = loss or JointLoss("joint")
    _check_trainable(base_model, ctc_model)
    _check_mesh(mesh)

    def eval_fn(params, batch) -> Metrics:
        batch = _batch_to(batch, tree_leaves(params)[0].device)
        with torch.no_grad():
            total, xe, ctc = _forward_losses(base_model, ctc_model, loss, params,
                                             batch, logit_length_fn, compute_dtype, mesh)
        return {"xe_loss": xe, "ctc_loss": ctc, "total_loss": total}

    return eval_fn
