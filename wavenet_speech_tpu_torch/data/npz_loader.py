"""Multiprocess NPZ-shard loader (wavenet_speech_tpu/data/npz_loader.py).

Layout: a glob of .npz shards, each holding arrays ``signals`` (an object
array of 1-D int or float signals, or a 2-D padded array with
``signal_lengths``) and ``reads`` (an object array of int label sequences,
or 2-D padded with ``read_lengths``).

Workers are processes, so the numpy decode and one-hot work runs beside the
training loop. Each worker draws from its own seed (``SeedSequence(seed)``
spawned once a worker), so its stream of batches is the JAX loader's; the
batches come over a queue as numpy arrays and become ``data.common.Batch``
on the consumer's side.

Workers are started with ``spawn``, where JAX forks. The port's loader runs
in a process that already holds a CUDA context and threads of its own
(checkpoint writers, the HDF5 loaders' producers, gloo), and a forked child
of such a process can hang on a lock that another thread held at the fork,
and cannot use CUDA. A spawned child imports this module (numpy and
``data.common`` only) and the starting script's top level, so that script
keeps its work under ``if __name__ == "__main__":``.
"""
from __future__ import annotations

import glob
import multiprocessing as mp
import queue as queue_mod
import time
from typing import List, Optional

import numpy as np

from wavenet_speech_tpu_torch.data.common import (Batch, one_hot_lc, pad_stack_labels,
                                                  pad_stack_lc)


def _load_shard(path: str):
    npz = np.load(path, allow_pickle=True)
    signals = npz["signals"]
    reads = npz["reads"]
    if signals.ndim == 2 and "signal_lengths" in npz:
        sl = npz["signal_lengths"]
        signals = np.array([signals[i, : sl[i]] for i in range(len(sl))],
                           dtype=object)
    if reads.ndim == 2 and "read_lengths" in npz:
        rl = npz["read_lengths"]
        reads = np.array([reads[i, : rl[i]] for i in range(len(rl))],
                         dtype=object)
    return signals, reads


def make_batch(paths: List[str], rng: np.random.Generator, batch_size: int,
               num_levels: int, one_hot: bool):
    """One batch as a worker builds it, drawing from ``rng``: a shard, then
    the reads. Returns (signal, labels, label_lengths, signal_lengths)."""
    path = paths[rng.integers(len(paths))]
    signals, reads = _load_shard(path)
    idx = rng.choice(len(signals), size=min(batch_size, len(signals)),
                     replace=False)
    sigs, labs = [], []
    for i in idx:
        s = np.asarray(signals[i])
        if one_hot:
            sigs.append(one_hot_lc(s.astype(np.int64), num_levels))
        else:
            sigs.append(s.astype(np.float32)[:, None])
        labs.append(np.asarray(reads[i], np.int32))
    return (
        pad_stack_lc(sigs),
        pad_stack_labels(labs),
        np.array([len(l) for l in labs], np.int32),
        np.array([s.shape[0] for s in sigs], np.int32),
    )


def _worker(paths: List[str], batch_size: int, num_levels: int,
            one_hot: bool, seed: int, out_q, stop_evt, max_batches: int):
    rng = np.random.default_rng(seed)
    produced = 0
    while not stop_evt.is_set() and produced < max_batches:
        payload = make_batch(paths, rng, batch_size, num_levels, one_hot)
        while not stop_evt.is_set():
            try:
                out_q.put(payload, timeout=0.1)
                produced += 1
                break
            except queue_mod.Full:
                continue


class NPZQueueLoader:
    """Iterator over batches built by worker processes from NPZ shards.
    ``worker_seeds[w]`` seeds worker w's ``np.random.default_rng``."""

    def __init__(self, shard_glob: str, batch_size: int = 8,
                 num_levels: int = 256, one_hot: bool = True,
                 num_workers: int = 1, queue_size: int = 16,
                 max_iters: int = 2 ** 30, seed: Optional[int] = None):
        self.paths = sorted(glob.glob(shard_glob))
        if not self.paths:
            raise FileNotFoundError(f"no NPZ shards match {shard_glob}")
        ctx = mp.get_context("spawn")   # not fork: see the module docstring
        self._q = ctx.Queue(queue_size)
        self._stop = ctx.Event()
        self.max_iters = max_iters
        self._consumed = 0
        per_worker = (max_iters + num_workers - 1) // num_workers
        # seed=None stays nondeterministic (fresh entropy per worker);
        # an explicit seed (including 0) gives reproducible streams
        base_ss = np.random.SeedSequence(seed)
        self.worker_seeds = [int(s.generate_state(1)[0])
                             for s in base_ss.spawn(num_workers)]
        self._procs = [
            ctx.Process(
                target=_worker,
                args=(self.paths, batch_size, num_levels, one_hot,
                      self.worker_seeds[w], self._q, self._stop, per_worker),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        for p in self._procs:
            p.start()

    def dequeue(self, timeout: float = 5.0) -> Batch:
        if self._consumed >= self.max_iters:
            raise StopIteration
        try:
            signal, labels, label_lengths, signal_lengths = self._q.get(
                timeout=timeout)
        except queue_mod.Empty:
            raise StopIteration
        self._consumed += 1
        return Batch(signal=signal, labels=labels,
                     label_lengths=label_lengths,
                     signal_lengths=signal_lengths)

    def close(self):
        """Stop the workers. A worker exits only once the batches it queued
        are through the pipe, so the queue is drained meanwhile; a worker
        still alive after 2 s (JAX's join timeout) is terminated."""
        self._stop.set()
        deadline = time.monotonic() + 2.0
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue_mod.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join()

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return self.dequeue()
