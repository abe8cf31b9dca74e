"""Multi-process set-up on ``torch.distributed``
(wavenet_speech_tpu/parallel/distributed.py:19-52).

Every process calls ``initialize_multihost`` with the same address and
world size and its own rank (from the arguments, else ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), then builds the same mesh
(``parallel.mesh.make_mesh``) and feeds its own shard of each batch. Nothing
tells a program of a cluster: the caller gives the address.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """``dist.init_process_group`` with environment fallbacks. init_method
    defaults to ``tcp://$MASTER_ADDR:$MASTER_PORT``. A no-op (returns
    False) for a single process: no address configured, or a world size of
    1. Returns True when a process group was set up. backend defaults to
    NCCL where there is a CUDA device, gloo elsewhere; NCCL refuses two
    ranks on one device, so such ranks pass "gloo"."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if init_method is None or (world_size or 1) == 1:
        return False
    if rank is None:
        raise ValueError("initialize_multihost: a world of several processes "
                         "needs each process's rank (argument or RANK)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes logs and checkpoint metadata."""
    return _process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process feeds (an even split over
    the processes)."""
    per = global_batch // _process_count()
    i = _process_index()
    return slice(i * per, (i + 1) * per)
