"""Rank programs for ``wavenet_speech_tpu_torch.parallel.run_ranks``, which
tests/test_torch_parallel.py and tests/test_torch_ctc_sharded.py run on
gloo ranks on the CPU against the JAX package. Each is the program one rank
of a DP/SP world runs: it builds a CPU mesh from ``mesh_shape`` (data, seq),
takes this rank's shard of the global inputs it is given, runs one piece of
the multi-device path, and returns this rank's results.

This module imports no jax: spawn imports it by name in every rank (the
test directory is on the ranks' ``sys.path``, as on the test process's).

    out = run_ranks(torch_rank_programs.joint_train_steps, 4, "gloo", (2, 2),
                    base, clf, params, batch, "adagrad", 1e-2, 3, 4)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from wavenet_speech_tpu_torch.parallel.ctc_sharded import ctc_loss_seq_sharded
from wavenet_speech_tpu_torch.parallel.halo import halo_pad, seq_sharded_apply
from wavenet_speech_tpu_torch.parallel.mesh import AXES, make_mesh
from wavenet_speech_tpu_torch.parallel.sharding import shard_batch, shard_params
from wavenet_speech_tpu_torch.training.loss import JointLoss
from wavenet_speech_tpu_torch.training.optimizer import build_optimizer
from wavenet_speech_tpu_torch.training.trainer import (TrainState, _forward_losses,
                                                       all_reduce_grads,
                                                       make_joint_train_step)
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_unflatten

MeshShape = Tuple[int, int]  # (data, seq)


def _mesh(mesh_shape: MeshShape):
    data, seq = mesh_shape
    return make_mesh(data=data, seq=seq, device="cpu")


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
                      logit_pool: Optional[int] = None) -> Dict[str, Any]:
    """``steps`` joint train steps (``make_joint_train_step(mesh=...)``) on
    this rank's shard of one global batch: each step's metrics and the
    final params."""
    mesh = _mesh(mesh_shape)
    tx = build_optimizer(optimizer, lr)
    step = make_joint_train_step(base_model, ctc_model, tx,
                                 logit_length_fn=_by_pool(logit_pool), mesh=mesh)
    state = TrainState.create(shard_params(mesh, params), tx)
    batch = shard_batch(mesh, batch, seq_keys=("signal",))
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
    return {"metrics": history, "params": state.params}
