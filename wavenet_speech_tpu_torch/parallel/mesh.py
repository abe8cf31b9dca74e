"""The device mesh over the ranks of a ``torch.distributed`` world
(wavenet_speech_tpu/parallel/mesh.py:19-46).

Axes, as in JAX:
  data  - batch (DP): the gradients are summed over the data and seq lines;
  model - channels (TP): params stored as output-channel slices and
          gathered at use (``parallel.sharding``);
  seq   - time (SP): the halo exchange at every conv (``parallel.halo``)
          and the sequence-sharded CTC (``parallel.ctc_sharded``).

Rank r sits at ``np.unravel_index(r, (data, model, seq))``, the place
``np.reshape`` gives device r in the JAX mesh. Each line of ranks along an
axis (the ranks that differ only in that axis) has its own process group;
every rank creates every group, in one order, as ``dist.new_group``
requires. A single process is a mesh of size 1 whose collectives are
no-ops.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from wavenet_speech_tpu_torch.utils.device import resolve_device

AXES = ("data", "model", "seq")


class Mesh:
    """This rank's view of the mesh: the axis sizes, its place, its device,
    and the process group of each of its lines."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device,
                 lines: Dict[str, List[int]], groups: Dict[str, object]):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.coords = dict(zip(AXES, np.unravel_index(rank, tuple(shape[a] for a in AXES))))
        self._lines, self._groups = lines, groups

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return int(self.coords[axis])

    def line(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along axis, in axis order."""
        return self._lines[axis]

    def group(self, axis: str):
        """The process group of this rank's line along axis (None where the
        axis has size 1)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={self.shape[a]}' for a in AXES)}; rank "
                f"{self.rank} at {tuple(int(self.coords[a]) for a in AXES)} on "
                f"{self.device})")


def _device_for(rank: int, device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)   # NCCL's P2P calls run on the current device
    return resolve_device(dev)


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A (data, model, seq) mesh over every rank of the world (one process:
    a mesh of size 1). data=None takes the ranks that model x seq leaves.
    device: this rank's device, by default ``cuda:<local rank % device
    count>`` (``LOCAL_RANK``, else the rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if world % (model * seq):
            raise ValueError(f"{world} ranks not divisible by model*seq={model * seq}")
        data = world // (model * seq)
    if data * model * seq != world:
        raise ValueError(f"mesh {data}x{model}x{seq} needs {data * model * seq} ranks, "
                         f"the world has {world}")
    shape = {"data": data, "model": model, "seq": seq}
    grid = np.arange(world).reshape(data, model, seq)
    lines, groups = {}, {}
    for k, axis in enumerate(AXES):
        # every line along axis: the other two coordinates fixed
        all_lines = np.moveaxis(grid, k, -1).reshape(-1, shape[axis]).tolist()
        for line in all_lines:
            group = dist.new_group(line) if shape[axis] > 1 else None
            if rank in line:
                lines[axis], groups[axis] = line, group
    return Mesh(shape, rank, _device_for(rank, device), lines,
                {a: g for a, g in groups.items() if g is not None})
