"""Placing params and batches on the mesh
(wavenet_speech_tpu/parallel/sharding.py:24-71).

DP and SP keep the params replicated: every rank holds them whole. Each
rank holds its shard of a batch: its rows over "data" and, for the
time-sharded arrays, its frames over "seq".

Tensor parallelism (TP) over the "model" axis follows JAX's rule leaf for
leaf (``param_shardings``): a leaf's last dim (a conv's or a dense layer's
output channels, a bias's only dim) is split evenly over "model" where it
divides; every other leaf, and every scalar, is replicated. A spec is the
sharded dim, or None for a replicated leaf.

In JAX that rule is an annotation: XLA inserts the collectives and splits
the arithmetic. Here it is storage: each rank keeps its slice of every
sharded leaf (``shard_params``), and so its slice of the gradients and of
the optimizer state, and the train step gathers the whole tree at the
start of the differentiated function (``gather_params``: one all-reduce of
one flat buffer), whose backward hands each rank its slice of the
gradients. The activations and the arithmetic are not split: every rank
of a "model" line computes the whole forward and backward of its (data,
seq) shard, and every layer, the fused causal block included, sees whole
weights, so the step's numbers are one device's. What TP buys here is
what JAX's docstring gives it for (parallel/mesh.py:6-7): params and
optimizer state of a net larger than one device's memory, spread over the
line. Splitting a conv's output channels would be a second form of every
kernel, which the JAX package does not have either.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from wavenet_speech_tpu_torch.parallel.collectives import gather_slices
from wavenet_speech_tpu_torch.parallel.mesh import Mesh
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Spec = Optional[int]   # the dim split over "model", or None: replicated


def _spec(leaf, model_size: int) -> Spec:
    shape = tuple(leaf.shape)
    if model_size == 1 or not shape or shape[-1] % model_size:
        return None
    return len(shape) - 1


def param_shardings(mesh: Mesh, params: Any, model_parallel: bool = False):
    """The spec of every leaf of a whole params tree (anything with a
    ``shape``): its last dim over "model" where model_parallel, the model
    axis is > 1 and the dim divides; else None (replicated)."""
    m = mesh.axis_size("model") if model_parallel else 1
    return tree_map(lambda leaf: _spec(leaf, m), params)


def local_slices(mesh: Mesh, params: Any, specs: Any):
    """This rank's slice of every whole leaf (a contiguous copy): along
    its spec's dim, the model index's 1/model share; a replicated leaf as
    it is. No collective."""
    i, n = mesh.axis_index("model"), mesh.axis_size("model")

    def take(t, spec):
        if spec is None:
            return t
        k = t.shape[spec] // n
        return t.narrow(spec, i * k, k).contiguous()

    return tree_map(take, params, specs)


def shard_params(mesh: Mesh, params: Any, model_parallel: bool = False):
    """A copy of the params tree on this rank's device: rank 0's values
    broadcast to every rank (one flat buffer a dtype), then, with
    model_parallel on a mesh whose "model" axis is > 1, this rank's slices
    (``param_shardings``)."""
    leaves = [torch.as_tensor(t).detach().to(mesh.device).clone() for t in tree_leaves(params)]
    if mesh.size > 1:
        for dtype in sorted({t.dtype for t in leaves}, key=str):
            group = [t for t in leaves if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
                t.copy_(part.view_as(t))
    whole = tree_unflatten(params, leaves)
    if not model_parallel or mesh.axis_size("model") == 1:
        return whole
    return local_slices(mesh, whole, param_shardings(mesh, whole, True))


def tp_sharded(mesh: Optional[Mesh], specs) -> bool:
    """Whether a tree with these specs is held as slices over the mesh's
    "model" axis (a TP mesh)."""
    return mesh is not None and specs is not None and mesh.axis_size("model") > 1


def gather_params(mesh: Mesh, params: Any, specs: Any):
    """The whole tree from this rank's slices (``shard_params(...,
    model_parallel=True)``'s layout, specs from ``param_shardings``):
    every sharded leaf gathered over "model", one all-reduce a dtype.
    Differentiable: the gradient of a gathered leaf is the cotangent's
    slice of this rank (see the module docstring). Every rank of the mesh
    must call it, in the same order."""
    if mesh.axis_size("model") == 1:
        return params
    leaves = tree_leaves(params)
    spec_leaves = tree_leaves(tree_map(lambda _, sp: sp, params, specs))
    out = list(leaves)
    for dtype in sorted({t.dtype for t, s in zip(leaves, spec_leaves) if s is not None},
                        key=str):
        idx = [j for j, (t, s) in enumerate(zip(leaves, spec_leaves))
               if s is not None and t.dtype == dtype]
        wholes = gather_slices([leaves[j] for j in idx], [spec_leaves[j] for j in idx],
                               mesh, "model")
        for j, w in zip(idx, wholes):
            out[j] = w
    return tree_unflatten(params, out)


def _signature(tree):
    if isinstance(tree, dict):
        return {k: _signature(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_signature(v) for v in tree]
    return tuple(getattr(tree, "shape", ()))


def state_specs(tree: Any, params: Any, specs: Any):
    """Specs for a tree that holds trees of params' structure and shapes
    (an optimizer state: adam's mu and nu, adagrad's sums): each such
    subtree gets specs, every other leaf (a step count) None."""
    want = _signature(params)

    def walk(t):
        if _signature(t) == want:
            return specs
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return None

    return walk(tree)


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
