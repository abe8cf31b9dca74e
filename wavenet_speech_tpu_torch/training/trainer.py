"""Train state, the joint and CTC-only train steps, and the eval step
(wavenet_speech_tpu/training/trainer.py).

The step is functional, as in JAX: ``step_fn(state, batch) -> (state,
metrics)``. Params are a tree ``{"base": {name: tensor}, "ctc": {name:
tensor}}`` keyed as the modules' state dicts (``param_tree``), and the
modules run on them through ``torch.func.functional_call``. Nothing in the
step reads a value back to the host: the skip guard selects on the device.

On the card the causal blocks run their forward and backward kernels (B4,
B5), the CTC its alpha and beta kernels (B1, B2), and the skip guard and
the optimizer the multi-tensor kernels (``ops.multi_tensor``: a few
launches a stage over every leaf); on the CPU the same step runs their
plain versions.

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
ones whose gradients are this rank's shares (``training/loss.py``). Batch
statistics (BatchNorm1d, ``batch_standardize``) are the global batch's
(``parallel.collectives.batch_stats``). The param gradients are summed
over the "data" and "seq" lines (one all-reduce of one flat buffer a
line) before the skip guard, so the guard, the norm and the optimizer run
on the same values on every rank: all ranks skip together and their
params stay identical.

On a mesh whose "model" axis is > 1 (TP), the state holds this rank's
slices (``parallel.shard_params(mesh, params, model_parallel=True)``; the
optimizer state follows): the differentiated function gathers the whole
tree first (``parallel.gather_params``), so the gradients come back as
slices; the guard reads the whole tree (the absmax a max over "model",
a sharded leaf's squares summed over "model", a replicated leaf counted
once), and so do the optimizer's norm clips (``optimizer.clip_norm``);
the replicated leaves' gradients are the first "model" rank's on every
rank of the line (``all_reduce_grads``). The step's numbers are one
device's (``parallel/sharding.py``).

The joint step trains either pair of ``facade.Model``: after the optimizer
update it calls the base model's ``update_state`` (a no-op for WaveNet;
``facade.BatchNorm1d``'s running-statistics EMA for raw-ctcnet), as JAX's
does. ``make_ctc_train_step`` trains one CTC network (RawCTCNet) alone, on
a mesh too. The JAX options ``donate`` and ``scan_unroll`` have no meaning
in an eager loop and are not taken.

Under an active ``torch.profiler`` each step marks its phases with
``utils.profiling.span``, once each, in this order: ``train.forward``
(the forward and the loss), ``train.backward`` (the gradients and, on a
mesh, their all-reduce), ``train.guard`` (the norm, the finiteness and
the gradients' masking), ``train.update`` (the optimizer, the masking of
its output, the new params) and, in the joint step, ``train.update_state``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from wavenet_speech_tpu_torch.ops import multi_tensor
from wavenet_speech_tpu_torch.parallel.collectives import (STAT_AXES, all_reduce,
                                                           batch_stats, broadcast)
from wavenet_speech_tpu_torch.parallel.halo import seq_axis
from wavenet_speech_tpu_torch.parallel.mesh import Mesh
from wavenet_speech_tpu_torch.parallel.sharding import (gather_params, param_shardings,
                                                        tp_sharded)
from wavenet_speech_tpu_torch.training.loss import JointLoss
from wavenet_speech_tpu_torch.training.optimizer import (GradientTransformation,
                                                         apply_updates, clip_norm)
from wavenet_speech_tpu_torch.utils.profiling import span
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


def _absmax(leaves) -> torch.Tensor:
    """The largest |x| of this rank's leaves; NaN if one holds a NaN."""
    return multi_tensor.absmax(leaves).max()


def _finite(absmax: torch.Tensor, mesh: Optional[Mesh], specs) -> torch.Tensor:
    ok = torch.isfinite(absmax)
    if tp_sharded(mesh, specs):
        ok = all_reduce(ok.to(torch.int32), mesh, "model", "min").bool()
    return ok


def _norm(leaves, absmax: torch.Tensor, mesh: Optional[Mesh], specs) -> torch.Tensor:
    tp = tp_sharded(mesh, specs)
    if tp:
        absmax = all_reduce(absmax, mesh, "model", "max")
    scale = torch.clamp(absmax, min=torch.finfo(torch.float32).tiny)
    if not tp:
        ssq = multi_tensor.total(multi_tensor.sum_squares(leaves, scale))
    else:
        split = tree_leaves(specs)
        sharded, replicated = ([l for l, s in zip(leaves, split) if (s is None) == rep]
                               for rep in (False, True))
        ssq = all_reduce(multi_tensor.total(multi_tensor.sum_squares(sharded, scale)),
                         mesh, "model") \
            + multi_tensor.total(multi_tensor.sum_squares(replicated, scale))
    return torch.where(absmax > 0, scale * torch.sqrt(ssq), 0.0)


def all_finite(tree, mesh: Optional[Mesh] = None, specs=None) -> torch.Tensor:
    """True iff every element of every leaf is finite (trainer.py:50-61):
    the leaves' absmax is finite (a NaN or an inf anywhere makes it NaN or
    inf). The skip guard's predicate: the finiteness of a naive global norm
    is false on finite gradients past ~1.8e19, whose squares overflow f32.
    With a TP mesh and the tree's specs, the whole tree's: this rank's
    slices and every other rank's of its "model" line."""
    return _finite(_absmax(tree_leaves(tree)), mesh, specs)


def global_norm_safe(tree, mesh: Optional[Mesh] = None, specs=None) -> torch.Tensor:
    """Overflow-proof global L2 norm (trainer.py:64-73): the leaves are
    scaled by the global absmax before squaring. 0 for an all-zero tree, NaN
    for a tree holding an inf, and 0 for one holding a NaN, as in JAX (whose
    docstring says non-finite; the skip guard reads all_finite, not this).
    With a TP mesh and the tree's specs, the whole tree's norm: the absmax
    a max over "model", a sharded leaf's squares summed over "model", a
    replicated leaf's counted once. Each pass over the leaves is one call
    of ``ops.multi_tensor`` (per-leaf results, so the mesh's split holds)."""
    leaves = tree_leaves(tree)
    return _norm(leaves, _absmax(leaves), mesh, specs)


def _batch_to(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _cast(tree, dtype):
    """Floating leaves cast to dtype (trainer.py:42-47); None leaves the
    tree as it is."""
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _sharded(mesh: Optional[Mesh]):
    """The region of a step on a mesh: sequence-sharded where the mesh
    shards time, its batch statistics the global batch's."""
    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(batch_stats(mesh))
    if mesh.axis_size("seq") > 1:
        stack.enter_context(seq_axis(mesh))
    return stack


def all_reduce_grads(grads, mesh: Optional[Mesh], specs=None):
    """The gradient tree summed over the "data" and "seq" lines (the whole
    mesh where "model" is 1), by one all-reduce of one flat buffer a line.
    Not over "model": on a TP mesh its ranks hold different slices of
    equal shape. There (specs given) the replicated leaves' gradients are
    then the first "model" rank's on every rank of its line: each rank
    computed them itself, and two processes need not sum in the same order
    (a CPU library may pick its reduction by a buffer's alignment), so the
    copies of a replicated leaf would drift apart."""
    if mesh is None:
        return grads
    leaves = tree_leaves(grads)
    if mesh.axis_size("data") * mesh.axis_size("seq") > 1:
        flat = all_reduce(torch.cat([g.reshape(-1) for g in leaves]), mesh, STAT_AXES)
        leaves = [p.view_as(g) for p, g in zip(torch.split(flat, [g.numel() for g in leaves]),
                                               leaves)]
    if tp_sharded(mesh, specs):
        idx = [j for j, s in enumerate(tree_leaves(specs)) if s is None]
        if idx:
            flat = broadcast(torch.cat([leaves[j].reshape(-1) for j in idx]), mesh, "model", 0)
            for j, part in zip(idx, torch.split(flat, [leaves[j].numel() for j in idx])):
                leaves[j] = part.view_as(leaves[j])
    return tree_unflatten(grads, leaves)


def _tp_specs(mesh: Optional[Mesh], whole_params):
    """The specs of a step's params on a TP mesh (``param_shardings`` of
    the whole tree, e.g. the modules' state dicts), None elsewhere."""
    if mesh is None or mesh.axis_size("model") == 1:
        return None
    return param_shardings(mesh, whole_params, model_parallel=True)


def _in_order(params, specs):
    """specs keyed and ordered as params (None stays None)."""
    return None if specs is None else tree_map(lambda _, sp: sp, params, specs)


def _whole(params, mesh: Optional[Mesh], specs):
    """The whole params tree from this rank's slices on a TP mesh
    (differentiable), else params."""
    return gather_params(mesh, params, specs) if tp_sharded(mesh, specs) else params


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


def _guarded_update(state: TrainState, total, grads, tx: GradientTransformation,
                    mesh: Optional[Mesh] = None, specs=None):
    """The skip guard and the optimizer update (trainer.py:168-182):
    all_finite and global_norm_safe, not the finiteness of a naive norm,
    which overflows f32 on finite gradients past ~1.8e19 and would freeze
    training. A step whose loss or gradients hold a non-finite value leaves
    params and optimizer state as they were. On a TP mesh both read the
    whole tree. Returns (params, opt_state, grad_norm, ok)."""
    with span("train.guard"):
        # the kernels read dense leaves: a gradient may come back strided
        leaves = [g.contiguous() for g in tree_leaves(grads)]
        absmax = _absmax(leaves)  # one pass serves the norm and the finiteness
        gnorm = _norm(leaves, absmax, mesh, specs)
        ok = torch.isfinite(total) & _finite(absmax, mesh, specs)
        grads = tree_unflatten(grads, multi_tensor.select(ok, leaves))
    with span("train.update"):
        with clip_norm(lambda tree: global_norm_safe(tree, mesh, specs)):
            updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        updates = tree_unflatten(updates, multi_tensor.select(ok, tree_leaves(updates)))
        opt_state = tree_unflatten(state.opt_state, multi_tensor.select(
            ok, tree_leaves(new_opt_state), tree_leaves(state.opt_state)))
        return apply_updates(state.params, updates), opt_state, gnorm, ok


def _leaves_with_grad(params):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    return leaves, tree_unflatten(params, leaves)


def _grads(total, params, leaves):
    # a leaf that reaches no output (the last block's residual projection,
    # BatchNorm's running statistics) gets zero gradients
    return tree_unflatten(params, list(torch.autograd.grad(
        total, leaves, allow_unused=True, materialize_grads=True)))


def _multi_step(step_fn, steps_per_call: int, multi_same_batch: bool):
    """run(state, batch): the batch moved to the params' device, then
    steps_per_call steps, on the same batch with multi_same_batch, else on
    batches stacked on a leading axis; the metrics then come back stacked
    (K,)."""

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
    still advances, and ``skipped_nonfinite`` is 1. Then, on every step,
    ``base_model.update_state(old base params, new base params, signal)``
    recomputes the base's non-gradient leaves (BatchNorm's running
    statistics) from the pre-update ones and the uncast signal.

    steps_per_call=K runs K steps a call: on the same batch with
    multi_same_batch, else on K batches stacked on a leading axis; the
    metrics then come back stacked (K,).

    mesh: run as one rank of a (data, model, seq) mesh, on this rank's
    shard of each batch (see the module docstring): the state's params
    are whole, or on a TP mesh this rank's slices; every rank must call
    the step with its shard.

    Returns step_fn(state, batch) -> (state, metrics)."""
    loss = loss or JointLoss("joint")
    specs = _tp_specs(mesh, {"base": base_model.state_dict(), "ctc": ctc_model.state_dict()})

    def step_fn(state: TrainState, batch) -> tuple:
        sp = _in_order(state.params, specs)
        with span("train.forward"):
            leaves, params = _leaves_with_grad(state.params)
            total, xe, ctc = _forward_losses(base_model, ctc_model, loss,
                                             _whole(params, mesh, sp), batch,
                                             logit_length_fn, compute_dtype, mesh)
        with span("train.backward"):
            grads = all_reduce_grads(_grads(total, state.params, leaves), mesh, sp)
        new_params, opt_state, gnorm, ok = _guarded_update(state, total, grads, tx, mesh, sp)
        # non-gradient state (BatchNorm's running statistics), from the
        # pre-update leaves and the uncast signal, on a skipped step too
        with span("train.update_state"), _sharded(mesh):
            new_params = dict(new_params, base=base_model.update_state(
                state.params["base"], new_params["base"], batch["signal"]))
        metrics = {"xe_loss": xe.detach(), "ctc_loss": ctc.detach(),
                   "total_loss": total.detach(), "grad_norm": gnorm,
                   "skipped_nonfinite": (~ok).to(torch.int32)}
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return _multi_step(step_fn, steps_per_call, multi_same_batch)


def make_ctc_train_step(model: nn.Module, tx: GradientTransformation,
                        average_per_logit: bool = True, use_logit_lengths: bool = False,
                        length_fn: Optional[Callable] = None, compute_dtype=None,
                        preprocess: Optional[Callable] = None, steps_per_call: int = 1,
                        multi_same_batch: bool = False, mesh: Optional[Mesh] = None):
    """The CTC-only step of one network, e.g. RawCTCNet (trainer.py:
    199-274), over its params {name: tensor} (its state dict's keys).
    batch: "signal" (B, L, C), "labels", "label_lengths" and, with
    use_logit_lengths, "signal_lengths".

    average_per_logit divides the batch-summed CTC by T (the reference's
    per-logit average); use_logit_lengths takes each sequence's logit
    length as length_fn(signal_lengths) (default: all T frames);
    compute_dtype casts params and signal inside the differentiated
    function, as in make_joint_train_step; preprocess maps the signal in
    its input dtype before that cast (e.g. ``ops.norm.batch_standardize``
    for raw pico-amp signals; on a mesh its statistics are the global
    batch's). The skip guard, steps_per_call and multi_same_batch are the
    joint step's.

    mesh: as the joint step's. Under SP (seq > 1) the network runs
    sequence-sharded and the CTC is ``parallel.ctc_loss_seq_sharded`` on
    the local logits; T (average_per_logit, the default logit lengths) is
    the global frame count, the local one times the seq axis. Returns
    step_fn(state, batch) -> (state, metrics)."""
    loss = JointLoss("ctc", averaged=average_per_logit)
    specs = _tp_specs(mesh, model.state_dict())

    def step_fn(state: TrainState, batch) -> tuple:
        sp = _in_order(state.params, specs)
        with span("train.forward"):
            leaves, params = _leaves_with_grad(state.params)
            params = _cast(_whole(params, mesh, sp), compute_dtype)
            with _sharded(mesh):
                signal = batch["signal"]
                if preprocess is not None:
                    signal = preprocess(signal)
                logits = functional_call(model, params, (_cast(signal, compute_dtype),))
            kwargs = {} if mesh is None else {"mesh": mesh}
            if use_logit_lengths and length_fn is not None:
                kwargs["logit_lengths"] = length_fn(batch["signal_lengths"])
            _, total = loss.calculate(None, None, logits, batch["labels"],
                                      batch["label_lengths"], **kwargs)
        with span("train.backward"):
            grads = all_reduce_grads(_grads(total, state.params, leaves), mesh, sp)
        new_params, opt_state, gnorm, ok = _guarded_update(state, total, grads, tx, mesh, sp)
        metrics = {"ctc_loss": total.detach(), "total_loss": total.detach(),
                   "grad_norm": gnorm, "skipped_nonfinite": (~ok).to(torch.int32)}
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return _multi_step(step_fn, steps_per_call, multi_same_batch)


def make_eval_step(base_model: nn.Module, ctc_model: nn.Module,
                   loss: Optional[JointLoss] = None, compute_dtype=None,
                   logit_length_fn: Optional[Callable] = None,
                   mesh: Optional[Mesh] = None):
    """The validation step (trainer.py:277-306): the train step's metrics
    and weighting, no update, in compute_dtype as the train step; with a
    mesh, on this rank's shard (params whole, or on a TP mesh this rank's
    slices), the global metrics on every rank. Returns
    eval_fn(params, batch) -> metrics."""
    loss = loss or JointLoss("joint")
    specs = _tp_specs(mesh, {"base": base_model.state_dict(), "ctc": ctc_model.state_dict()})

    def eval_fn(params, batch) -> Metrics:
        batch = _batch_to(batch, tree_leaves(params)[0].device)
        with torch.no_grad():
            total, xe, ctc = _forward_losses(
                base_model, ctc_model, loss, _whole(params, mesh, _in_order(params, specs)),
                batch, logit_length_fn, compute_dtype, mesh)
        return {"xe_loss": xe, "ctc_loss": ctc, "total_loss": total}

    return eval_fn
