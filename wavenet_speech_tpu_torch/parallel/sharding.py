"""Placing params and batches on the mesh
(wavenet_speech_tpu/parallel/sharding.py:38-71).

DP and SP keep the params replicated: every rank holds them whole, and the
train step sums the gradients over every rank. Each rank holds its shard
of a batch: its rows over "data" and, for the time-sharded arrays, its
frames over "seq".

Tensor parallelism over the "model" axis (JAX's output-channel shardings)
is not ported: in JAX it is annotations that XLA turns into collectives,
in torch a column-parallel rewrite of every conv (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist

from wavenet_speech_tpu_torch.parallel.mesh import Mesh
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def shard_params(mesh: Mesh, params: Any, model_parallel: bool = False):
    """A copy of the params tree on this rank's device, replicated: rank
    0's values broadcast to every rank (one flat buffer)."""
    if model_parallel:
        raise NotImplementedError("tensor parallelism over the 'model' axis is not "
                                  "ported (ROADMAP A12); params are replicated")
    leaves = [torch.as_tensor(t).detach().to(mesh.device).clone() for t in tree_leaves(params)]
    if mesh.size > 1:
        for dtype in sorted({t.dtype for t in leaves}, key=str):
            group = [t for t in leaves if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return tree_unflatten(params, leaves)


def shard_batch(mesh: Mesh, batch: Dict[str, Any],
                seq_keys: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """This rank's shard of a global batch, on its device: the leading dim
    of every array split evenly over "data", and dim 1 of the arrays named
    in seq_keys (a train batch's "signal") over "seq"."""
    seq_keys = set(seq_keys)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        for dim, axis in ((0, "data"), (1, "seq")):
            if axis == "seq" and key not in seq_keys:
                continue
            n, i = mesh.axis_size(axis), mesh.axis_index(axis)
            if t.shape[dim] % n:
                raise ValueError(f"shard_batch: {key} has {t.shape[dim]} along dim {dim}, "
                                 f"not divisible by the {axis} axis's {n}")
            per = t.shape[dim] // n
            t = t.narrow(dim, i * per, per)
        out[key] = t.contiguous().to(mesh.device)
    return out
