"""Rank programs for ``wavenet_speech_tpu_torch.parallel.run_ranks``, which
tests/test_torch_parallel.py and tests/test_torch_ctc_sharded.py run on
gloo ranks on the CPU against the JAX package. Each is the program one rank
of a DP/TP/SP world runs: it builds a CPU mesh from ``mesh_shape`` ((data,
seq), or (data, model, seq)), takes this rank's shard of the global inputs
it is given, runs one piece of the multi-device path, and returns this
rank's results. tests/test_torch_tp.py, test_torch_distributed_decode.py
and test_torch_raw_ctcnet.py spawn them too.

This module imports no jax: spawn imports it by name in every rank (the
test directory is on the ranks' ``sys.path``, as on the test process's).

    out = run_ranks(torch_rank_programs.joint_train_steps, 4, "gloo", (2, 2),
                    base, clf, params, batch, "adagrad", 1e-2, 3, 4)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from wavenet_speech_tpu_torch.decoding import distributed_beam_decode, seq_sharded_beam_decode
from wavenet_speech_tpu_torch.parallel.collectives import all_reduce, gather_axis
from wavenet_speech_tpu_torch.parallel.ctc_sharded import ctc_loss_seq_sharded
from wavenet_speech_tpu_torch.parallel.halo import halo_pad, seq_axis, seq_sharded_apply
from wavenet_speech_tpu_torch.parallel.mesh import AXES, make_mesh
from wavenet_speech_tpu_torch.parallel.sharding import (gather_params, param_shardings,
                                                        shard_batch, shard_params,
                                                        state_specs)
from wavenet_speech_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from wavenet_speech_tpu_torch.training.loss import JointLoss
from wavenet_speech_tpu_torch.training.optimizer import build_optimizer
from wavenet_speech_tpu_torch.training.trainer import (TrainState, _forward_losses,
                                                       all_reduce_grads,
                                                       make_ctc_train_step,
                                                       make_eval_step,
                                                       make_joint_train_step)
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

MeshShape = Tuple[int, ...]  # (data, seq) or (data, model, seq)


def _mesh(mesh_shape: MeshShape, device: str = "cpu"):
    data, model, seq = mesh_shape if len(mesh_shape) == 3 else (mesh_shape[0], 1, mesh_shape[1])
    return make_mesh(data=data, model=model, seq=seq, device=device)


def _is_last(mesh) -> bool:
    return mesh.axis_index("seq") == mesh.axis_size("seq") - 1


def _by_pool(pool: Optional[int]):
    """The length-aware mode's logit lengths: signal lengths // pool."""
    return None if pool is None else (lambda lengths: lengths // pool)


def mesh_layout(mesh_shape: MeshShape) -> Dict[str, Any]:
    """This rank's place on the mesh and its lines."""
    mesh = _mesh(mesh_shape)
    return {"coords": [mesh.axis_index(a) for a in AXES],
            "lines": {a: mesh.line(a) for a in AXES}}


def halo_pad_value_and_grad(mesh_shape: MeshShape, x, left: int, right: int, weight):
    """``halo_pad`` of this rank's time shard of x (B, L, C), and the
    gradient of sum(weight * padded) over all ranks with respect to it;
    weight is the padded shards laid end to end (B, n * (L/n + left +
    right), C)."""
    mesh = _mesh(mesh_shape)
    xs = shard_batch(mesh, {"x": x}, seq_keys=("x",))["x"].requires_grad_(True)
    w = shard_batch(mesh, {"w": weight}, seq_keys=("w",))["w"]
    y = halo_pad(xs, left, right, mesh)
    grad, = torch.autograd.grad((y * w).sum(), xs)
    return y.detach(), grad


def ctc_value_and_grad(mesh_shape: MeshShape, logits, logit_lengths, labels,
                       label_lengths):
    """``ctc_loss_seq_sharded`` on this rank's (data, seq) shard of logits
    (B, T, C) and of the per-sequence inputs: the losses of its rows, and
    the gradient of the summed loss (counted on the last seq rank) with
    respect to its shard."""
    mesh = _mesh(mesh_shape)
    rows = shard_batch(mesh, {"l": logits, "tl": logit_lengths, "lab": labels,
                              "ll": label_lengths}, seq_keys=("l",))
    lg = rows["l"].requires_grad_(True)
    losses = ctc_loss_seq_sharded(mesh, lg, rows["tl"], rows["lab"], rows["ll"])
    grad, = torch.autograd.grad(losses.sum() * (1.0 if _is_last(mesh) else 0.0), lg)
    return losses.detach(), grad


def block_value_and_grad(mesh_shape: MeshShape, block, x, weights: Sequence):
    """A ``ResidualBlock`` on this rank's time shard of x (B, L, C_in)
    (``seq_sharded_apply``): its two outputs, and the gradients of
    sum(w_r * resid + w_s * skip) over all ranks with respect to the shard
    and (summed over the ranks) the block's params."""
    mesh = _mesh(mesh_shape)
    xs = shard_batch(mesh, {"x": x}, seq_keys=("x",))["x"].requires_grad_(True)
    w = shard_batch(mesh, {"r": weights[0], "s": weights[1]}, seq_keys=("r", "s"))
    resid, skip = seq_sharded_apply(block, mesh, xs)
    params = list(block.parameters())
    grads = torch.autograd.grad((resid * w["r"]).sum() + (skip * w["s"]).sum(),
                                [xs, *params])
    return resid.detach(), skip.detach(), grads[0], all_reduce_grads(list(grads[1:]), mesh)


def joint_value_and_grad(mesh_shape: MeshShape, base_model, ctc_model, params, batch,
                         logit_pool: Optional[int] = None,
                         loss: Optional[JointLoss] = None) -> Dict[str, Any]:
    """The train step's objective on this rank's (data, seq) shard of the
    global batch: the global loss terms and the gradient tree summed over
    every rank (the single-device gradient)."""
    mesh = _mesh(mesh_shape)
    params = shard_params(mesh, params)
    batch = shard_batch(mesh, batch, seq_keys=("signal",))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    total, xe, ctc = _forward_losses(base_model, ctc_model, loss or JointLoss("joint"),
                                     params, batch, _by_pool(logit_pool), None, mesh)
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    grads = all_reduce_grads(tree_unflatten(params, list(grads)), mesh)
    return {"total": total.detach(), "xe": xe.detach(), "ctc": ctc.detach(),
            "grads": grads}


def joint_train_steps(mesh_shape: MeshShape, base_model, ctc_model, params, batch,
                      optimizer: str, lr: float, steps: int,
                      logit_pool: Optional[int] = None,
                      loss: Optional[JointLoss] = None) -> Dict[str, Any]:
    """``steps`` joint train steps (``make_joint_train_step(mesh=...)``) on
    this rank's shard of one global batch (the params TP-sharded where the
    mesh has a "model" axis > 1): each step's metrics, the final params
    (whole, gathered), the shapes of this rank's params, and the eval
    step's metrics on the final params."""
    mesh = _mesh(mesh_shape)
    tp = mesh.axis_size("model") > 1
    tx = build_optimizer(optimizer, lr)
    step = make_joint_train_step(base_model, ctc_model, tx, loss,
                                 logit_length_fn=_by_pool(logit_pool), mesh=mesh)
    state = TrainState.create(shard_params(mesh, params, model_parallel=tp), tx)
    batch = shard_batch(mesh, batch, seq_keys=("signal",))
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
    evaluate = make_eval_step(base_model, ctc_model, loss, logit_length_fn=_by_pool(logit_pool),
                              mesh=mesh)
    specs = param_shardings(mesh, params, model_parallel=tp)
    with torch.no_grad():
        whole = gather_params(mesh, state.params, specs)
    return {"metrics": history, "params": whole,
            "local_shapes": tree_map(lambda t: tuple(t.shape), state.params),
            "eval": evaluate(state.params, batch)}


def ctc_train_steps(mesh_shape: MeshShape, net, params, batch, steps: int,
                    ckpt_in: Optional[str] = None, ckpt_out: Optional[str] = None,
                    max_update_norm: Optional[float] = None):
    """``steps`` Adam steps (1e-3, the update clipped to max_update_norm by
    the whole tree's norm) of ``make_ctc_train_step(mesh=...)`` on this
    rank's shard of one global batch, the params TP-sharded where the mesh
    has a "model" axis > 1 (the TP forward of ``params`` first): the
    forward's logits on the whole batch, each step's metrics, the final
    state gathered whole. With ckpt_in, first the checkpoint there is
    restored into the TP template (this rank's slices returned, then
    training starts from params); with ckpt_out, the final state is saved
    there."""
    mesh = _mesh(mesh_shape)
    tp = mesh.axis_size("model") > 1
    specs = param_shardings(mesh, params, model_parallel=tp)
    tx = build_optimizer("adam", 1e-3, max_update_norm=max_update_norm)
    local = shard_params(mesh, params, model_parallel=tp)
    out = {}
    with torch.no_grad():
        x = torch.as_tensor(batch["signal"])
        out["logits"] = functional_call(net, gather_params(mesh, local, specs), (x,))
    if ckpt_in is not None:
        restored = restore_checkpoint(ckpt_in, TrainState.create(local, tx), mesh=mesh,
                                      specs=specs)
        out["restored"] = {"params": restored.params, "opt_state": restored.opt_state,
                           "step": restored.step}
    state = TrainState.create(local, tx)
    step = make_ctc_train_step(net, tx, mesh=mesh)
    rows = shard_batch(mesh, batch)
    history = []
    for _ in range(steps):
        state, metrics = step(state, rows)
        history.append(metrics)
    if ckpt_out is not None:
        save_checkpoint(ckpt_out, state, mesh=mesh, specs=specs)
    with torch.no_grad():
        out["params"] = gather_params(mesh, state.params, specs)
        out["opt_state"] = gather_params(mesh, state.opt_state,
                                         state_specs(state.opt_state, state.params, specs))
    out["metrics"] = history
    return out


def raw_ctcnet_sp(mesh_shape: MeshShape, net, params, signal, labels, label_lengths,
                  weight=None) -> Dict[str, Any]:
    """RawCTCNet under SP on this rank's (data, seq) shard of signal (B, L,
    1): with labels, the CTC loss (a batch sum over the global T, as
    ``JointLoss("ctc")``) and the gradient tree summed over the ranks; with
    weight (B, L + fk - 1, C) instead, the logits' shards gathered over
    "seq" and the gradient of sum(weight * logits). Either in the params'
    dtype."""
    mesh = _mesh(mesh_shape)
    params = shard_params(mesh, params)
    rows = shard_batch(mesh, {"s": signal}, seq_keys=("s",))["s"]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    with seq_axis(mesh):
        logits = functional_call(net, params, (rows,))
    if labels is None:
        w = shard_batch(mesh, {"w": weight}, seq_keys=("w",))["w"]
        total = (logits * w).sum()
    else:
        lab = shard_batch(mesh, {"l": labels, "ll": label_lengths})
        total = JointLoss("ctc").calculate(None, None, logits, lab["l"], lab["ll"],
                                           mesh=mesh)[1]
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    return {"total": all_reduce(total, mesh) if labels is None else total.detach(),
            "logits": gather_axis(logits.detach(), mesh, "seq", 1),
            "grads": all_reduce_grads(tree_unflatten(params, list(grads)), mesh)}


def decoders(mesh_shape: MeshShape, logits, lengths, beam_width: int, max_label_len: int,
             device: str = "cpu"):
    """``distributed_beam_decode`` and ``seq_sharded_beam_decode`` (with
    and without data_sharded) of the global logits on this rank, on device
    (the card: B6)."""
    mesh = _mesh(mesh_shape, device)
    kw = dict(beam_width=beam_width, max_label_len=max_label_len)
    return {"batch": distributed_beam_decode(mesh, logits, lengths, **kw),
            "seq": seq_sharded_beam_decode(mesh, logits, lengths, **kw),
            "seq_data": seq_sharded_beam_decode(mesh, logits, lengths, data_sharded=True,
                                                **kw)}


def gather_model(mesh_shape: MeshShape, x, dim: int, device: str = "cpu"):
    """``collectives.gather_axis`` over "model" of this rank's slice of x
    along dim (its model index's share), on device."""
    mesh = _mesh(mesh_shape, device)
    n, i = mesh.axis_size("model"), mesh.axis_index("model")
    k = x.shape[dim] // n
    return gather_axis(x.narrow(dim, i * k, k).to(mesh.device), mesh, "model", dim)


def replicated_grads(mesh_shape: MeshShape, grads, specs):
    """``trainer.all_reduce_grads`` on a TP mesh of grads plus 0.5 x this
    rank's number in every leaf (the ranks' own sums made to differ), and
    this rank's (data, model, seq) coordinates."""
    mesh = _mesh(mesh_shape)
    mine = tree_map(lambda g: g + 0.5 * mesh.rank, grads)
    return {"grads": all_reduce_grads(mine, mesh, specs),
            "coords": tuple(mesh.axis_index(a) for a in AXES)}


def several(calls):
    """Each (program, args) of calls in turn on this rank, in one world
    (one spawn for several checks); their results in order."""
    return [fn(*args) for fn, args in calls]
