"""Starting the ranks of a ``torch.distributed`` world on one machine.

``run_ranks(fn, world_size, backend, *args)`` spawns ``world_size``
processes on a free TCP port of localhost; each sets up the process group
(``initialize_multihost``), runs ``fn(*args)``, and sends its result back
(serialised with ``torch.save``, tensors moved to the CPU). The results
come back in rank order. A rank that raises, or a run that outlasts
``timeout``, stops every rank and raises here: a rank waiting on a
collective whose peer has died would otherwise wait forever.

fn must be importable by name (a module-level function; spawn pickles it
by reference), in a module the ranks can import (spawn gives them the
caller's ``sys.path``), such as chip_smoke.py's ``sp_rank``. fn and args
reach the ranks through a queue, not the process's start arguments: a
spawned child reads those only as it imports what they name (torch, fn's
module), so a start argument past a pipe's buffer would hold each start
for seconds.
"""
from __future__ import annotations

import io
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist

from wavenet_speech_tpu_torch.parallel.distributed import initialize_multihost
from wavenet_speech_tpu_torch.utils.tree import tree_map


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_cpu(x):
    return x.detach().cpu() if torch.is_tensor(x) else x


def _rank_main(rank, world_size, backend, port, threads, inputs, results):
    try:
        torch.set_num_threads(threads)
        fn, args = pickle.loads(inputs.get())
        initialize_multihost(f"tcp://127.0.0.1:{port}", world_size, rank, backend)
        out = fn(*args)
        buf = io.BytesIO()
        torch.save(tree_map(_to_cpu, out), buf)
        results.put((rank, True, buf.getvalue()))
    except Exception:   # reported to run_ranks, which stops the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, backend: str, *args: Any,
              timeout: float = 600.0) -> List[Any]:
    """fn(*args) on each of world_size spawned ranks of one process group
    (backend "gloo" or "nccl"); returns the ranks' results in rank order.
    Raises RuntimeError if a rank fails or dies, or the run outlasts
    timeout seconds; every rank is stopped first."""
    ctx = multiprocessing.get_context("spawn")
    inputs, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    threads = max(1, (os.cpu_count() or 1) // world_size)
    payload = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, port, threads, inputs, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
        inputs.put(payload)
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    failure = None
    try:
        while failure is None and len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in
                        (None, 0)]
                if dead:
                    failure = f"run_ranks: ranks {dead} died (exit codes " \
                              f"{[procs[r].exitcode for r in dead]})"
                elif time.monotonic() > deadline:
                    failure = f"run_ranks: timed out after {timeout:.0f} s"
                continue
            if not ok:
                failure = f"run_ranks: rank {rank} failed:\n{payload}"
            else:
                out[rank] = torch.load(io.BytesIO(payload), weights_only=False)
    finally:
        for p in procs:
            p.join(timeout=30 if failure is None else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
