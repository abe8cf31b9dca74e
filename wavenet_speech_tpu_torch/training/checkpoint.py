"""Resumable checkpoints as torch files (wavenet_speech_tpu/training/
checkpoint.py, which writes Orbax; Orbax's format is not a goal here).

A full-state checkpoint is params + optimizer state + step, so a resumed run
continues the schedule. Layout: ``<ckpt_dir>/<step>/state.pt``, written to a
temporary directory first and renamed into place, so a directory named by a
step is always complete. ``async_save=True`` copies the state to host
memory, then writes it on a writer thread while training goes on; at most
one save per directory is in flight, and the interpreter waits for the
writers before it exits. ``max_to_keep=N`` keeps the newest N step
directories after a save (orbax's ``max_to_keep``); an async save rotates
after its write. A rotated directory is first renamed out of the step
names, so ``latest_step`` and ``restore_checkpoint`` never see one half
deleted.

A TP state (``parallel.shard_params(..., model_parallel=True)``: each rank
holds its slices of the params and of the optimizer state) is saved whole:
with ``mesh`` and the params' ``specs`` every rank gathers the whole state
over its "model" line and the primary rank writes it. Restoring with
``mesh`` and ``specs`` into such a template takes each rank's slices. So a
checkpoint is the same file whatever the mesh that wrote it, and restores
on one device or on a TP mesh alike.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from wavenet_speech_tpu_torch.parallel.mesh import Mesh
from wavenet_speech_tpu_torch.parallel.sharding import (gather_params, local_slices,
                                                        state_specs, tp_sharded)
from wavenet_speech_tpu_torch.training.trainer import TrainState
from wavenet_speech_tpu_torch.utils.tree import tree_map

STATE_FILE = "state.pt"
_WRITERS: Dict[str, "_Writer"] = {}  # abs ckpt_dir -> its save in flight


class _Writer(threading.Thread):
    """Writes one checkpoint; a failure is raised again by join()."""

    def __init__(self, *args):
        super().__init__(target=None)
        self.args, self.error = args, None

    def run(self):
        try:
            _write(*self.args)
        except BaseException as e:  # raised again in the training thread
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


def _to_host(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if torch.is_tensor(t) else t, tree)


def _write(ckpt_dir: str, step: int, payload, max_to_keep: Optional[int]) -> None:
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, os.path.join(ckpt_dir, str(step)))
    if max_to_keep is not None:
        _rotate(ckpt_dir, max_to_keep)


def _rotate(ckpt_dir: str, max_to_keep: int) -> None:
    """Delete all but the newest max_to_keep step directories: each is
    renamed to a hidden name (atomic) before it is removed."""
    for step in _steps(ckpt_dir)[:-max_to_keep]:
        doomed = os.path.join(ckpt_dir, f".{step}.del-{os.getpid()}")
        os.replace(os.path.join(ckpt_dir, str(step)), doomed)
        shutil.rmtree(doomed)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None,
                    async_save: bool = False, max_to_keep: Optional[int] = None,
                    mesh: Optional[Mesh] = None, specs: Any = None) -> int:
    """Save a TrainState under ckpt_dir/<step>/; returns the step saved.
    Saving a step that already exists does nothing (the CLI's save on exit
    often repeats the periodic save's step). With async_save the state is
    copied to the host here and written on a writer thread; the previous
    save to this directory is waited for first. Call
    wait_for_async_saves() before restoring from the directory.
    max_to_keep: after the write, keep only the newest max_to_keep step
    directories (None keeps all). mesh and specs: a TP state, gathered
    whole (every rank must call this), written by the mesh's rank 0."""
    if max_to_keep is not None and max_to_keep < 1:
        raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
    step = int(state.step) if step is None else int(step)
    params, opt_state = state.params, state.opt_state
    if tp_sharded(mesh, specs):
        with torch.no_grad():
            params = gather_params(mesh, params, specs)
            opt_state = gather_params(mesh, opt_state,
                                      state_specs(opt_state, state.params, specs))
        if mesh.rank != 0:
            return step
    key = os.path.abspath(ckpt_dir)
    wait_for_async_saves(key)  # <= one save in flight per directory
    os.makedirs(key, exist_ok=True)
    if os.path.isdir(os.path.join(key, str(step))):
        return step
    payload = {"params": _to_host(params), "opt_state": _to_host(opt_state), "step": step}
    if not async_save:
        _write(key, step, payload, max_to_keep)
        return step
    writer = _Writer(key, step, payload, max_to_keep)
    writer.start()
    _WRITERS[key] = writer
    return step


def wait_for_async_saves(ckpt_dir: Optional[str] = None) -> None:
    """Block until the in-flight saves (of one directory, or all) are
    written; raise the error of a save that failed."""
    keys = [os.path.abspath(ckpt_dir)] if ckpt_dir else list(_WRITERS)
    for k in keys:
        writer = _WRITERS.pop(k, None)
        if writer is not None:
            writer.join()


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isfile(os.path.join(ckpt_dir, n, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(got, like, path: str = ""):
    """got checked against the structure, shapes and types of like, and
    placed on like's devices."""
    if isinstance(like, dict):
        if not isinstance(got, dict) or set(got) != set(like):
            raise ValueError(f"checkpoint structure differs at {path or '/'}: keys "
                             f"{sorted(got) if isinstance(got, dict) else type(got)} "
                             f"!= {sorted(like)}")
        return {k: _like(got[k], v, f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(got) != len(like):
            raise ValueError(f"checkpoint structure differs at {path or '/'}")
        return type(like)(_like(g, v, f"{path}/{i}") for i, (g, v) in enumerate(zip(got, like)))
    if not torch.is_tensor(got) or got.shape != like.shape or got.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {path}: {getattr(got, 'shape', type(got))} "
                         f"{getattr(got, 'dtype', '')} != {like.shape} {like.dtype}")
    return got.to(like.device)


def restore_checkpoint(ckpt_dir: str, state_like: TrainState,
                       step: Optional[int] = None, mesh: Optional[Mesh] = None,
                       specs: Any = None) -> TrainState:
    """The checkpoint at ``step`` (default the latest) as a TrainState of
    state_like's structure, on its devices; raises ValueError when the
    structure, a shape or a type differs. With mesh and specs, state_like
    is a TP state: each rank takes its slices of the whole checkpoint."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    payload = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                         map_location="cpu", weights_only=True)
    params, opt_state = payload["params"], payload["opt_state"]
    if tp_sharded(mesh, specs):
        opt_state = local_slices(mesh, opt_state, state_specs(opt_state, params, specs))
        params = local_slices(mesh, params, specs)
    return TrainState(params=_like(params, state_like.params, "params"),
                      opt_state=_like(opt_state, state_like.opt_state, "opt_state"),
                      step=torch.tensor(payload["step"], dtype=torch.int32,
                                        device=state_like.step.device))


def save_params(path: str, params: Any) -> None:
    """One params tree as one torch file (the reference's per-model .pt
    file, for export)."""
    torch.save(_to_host(params), path)


def restore_params(path: str, params_like: Any) -> Any:
    return _like(torch.load(path, map_location="cpu", weights_only=True), params_like)
