"""Sequence parallelism for the dilated conv stacks by halo exchange
(wavenet_speech_tpu/parallel/halo.py:33-94).

The time axis is sharded over the mesh's "seq" axis, and at every conv
only the (k-1)*d boundary frames move between neighbouring shards. The
convs (``ops.conv``) and the causal block (``models.blocks``) consult
``current_seq_axis()``: inside ``seq_axis(mesh)`` they take their left (and
for the non-causal ones, right) context from the neighbouring shards with
``halo_pad``, whose zeros at the ends of the line reproduce the zero
padding at the global sequence edges.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from wavenet_speech_tpu_torch.parallel.collectives import shift
from wavenet_speech_tpu_torch.parallel.mesh import Mesh

_state = threading.local()


def current_seq_axis() -> Optional[Mesh]:
    """The mesh whose "seq" axis the current region is sharded over, or
    None outside ``seq_axis``."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def seq_axis(mesh: Mesh):
    """Run the region sequence-sharded over mesh's "seq" axis: every conv
    inside exchanges halos."""
    prev = current_seq_axis()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def halo_pad(x: torch.Tensor, left: int, right: int, mesh: Mesh) -> torch.Tensor:
    """x (B, L_shard, C) with the previous shard's last ``left`` frames
    before it and the next shard's first ``right`` frames after it (zeros
    at the ends of the line). Differentiable. A halo must fit in one shard
    (there is no multi-hop exchange)."""
    L = x.shape[1]
    if max(left, right) > L:
        raise ValueError(f"halo ({left},{right}) exceeds sequence shard length {L}; "
                         f"use fewer seq shards or longer signals")
    parts = []
    if left > 0:
        parts.append(shift(x[:, L - left:], mesh, "seq", 1))
    parts.append(x)
    if right > 0:
        parts.append(shift(x[:, :right], mesh, "seq", -1))
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def seq_sharded_apply(fn: Callable, mesh: Mesh, x: torch.Tensor):
    """fn(x) on this rank's time shard x, with a halo exchange at every
    conv; returns this rank's shard of the output. fn must work shard by
    shard: convs keep the length, and the classifier's pool needs
    L_shard % pool == 0."""
    with seq_axis(mesh):
        return fn(x)
