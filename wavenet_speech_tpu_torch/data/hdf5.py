"""HDF5-backed loaders for real nanopore reads, copied from
wavenet_speech_tpu/data/hdf5.py (the reference's utils/loaders.py and
utils/worker_fns.py) with the same names and behaviour.

QueueLoader: N daemon producer threads run a worker function over an opened
HDF5 file and push batches onto bounded per-split queues (70/30 train/valid
key split, loaders.py:50-53); ``dequeue`` pops with a timeout and turns an
empty queue into StopIteration (loaders.py:94-112). The producers build the
next batches on the host while the card runs the step; with more than one
worker the batch order follows the threads.

``h5py`` is imported by the loaders' constructors only, so this module
imports without it. ``ecoli_worker_fn`` only indexes the handle it is given.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from wavenet_speech_tpu_torch.data.common import (Batch, one_hot_lc, pad_stack_lc,
                                                  pad_stack_labels)


def ecoli_worker_fn(hdf5_handle, keys: Sequence[str], rng,
                    batch_size: int = 8,
                    sample_lengths: Tuple[int, int] = (90, 110),
                    num_levels: int = 256,
                    pad_to: Optional[int] = None,
                    labels_pad_to: Optional[int] = None,
                    debug_mode: bool = False,
                    device_onehot: bool = False):
    """Build one batch from a random read (reference utils/worker_fns.py:
    13-64): sample subintervals of the eventalign ``raw/positions`` index,
    slice the ``reference`` bases (+4 for the 5-mer adjustment), concatenate
    the per-event ``quantized`` sample chunks, one-hot to num_levels; with
    device_onehot the signal stays (B, L) int32 levels, which the train step
    one-hots on the card. debug_mode returns (read, subintervals, batch)."""
    read = keys[rng.integers(len(keys))]
    quantized = hdf5_handle[read]["quantized"]
    positions = hdf5_handle[read]["raw"]["positions"]
    references = hdf5_handle[read]["reference"]

    lens = rng.integers(sample_lengths[0], sample_lengths[1], size=batch_size)
    starts = rng.integers(0, positions.shape[0] - sample_lengths[1], size=batch_size)
    stops = starts + lens
    subintervals = list(zip(starts.tolist(), stops.tolist()))

    base_seqs = []
    pos0 = positions[0]
    for start_ix, stop_ix in subintervals:
        move_to_start = positions[start_ix] - pos0
        move_to_stop = (positions[stop_ix] - pos0) + 4  # +4: 5-mer adjustment
        base_seqs.append(np.asarray(references[move_to_start:move_to_stop], dtype=np.int32))

    signals = []
    for start_ix, stop_ix in subintervals:
        subsignal = np.concatenate(quantized[start_ix:stop_ix])
        if device_onehot:
            # the levels are num_levels x smaller than their one-hot (39 KB
            # against 10 MB a batch at the ecoli config) to copy to the card
            signals.append(subsignal.astype(np.int32))
        else:
            signals.append(one_hot_lc(subsignal.astype(np.int64), num_levels))

    batch = Batch(
        signal=(pad_stack_labels(signals, pad_to) if device_onehot
                else pad_stack_lc(signals, pad_to)),
        labels=pad_stack_labels(base_seqs, labels_pad_to),
        label_lengths=np.array([len(s) for s in base_seqs], np.int32),
        signal_lengths=np.array([s.shape[0] for s in signals], np.int32),
    )
    if debug_mode:
        return read, subintervals, batch
    return batch


class QueueLoader:
    """Threaded producer/consumer loader (reference utils/loaders.py:14-129).
    The file's keys are shuffled by ``default_rng(seed)`` and split 70/30
    into train and valid; each of num_workers workers runs one producer a
    split, on ``default_rng(seed + 1000 + 2 w + i)`` (i = 0 train, 1 valid).
    Only train batches count against max_iters."""

    def __init__(self, dataset_path: str, num_epochs: int = 1,
                 max_iters: Optional[int] = None, num_workers: int = 1,
                 queue_size: int = 50, batch_size: int = 8,
                 sample_lengths: Tuple[int, int] = (90, 110),
                 num_levels: int = 256, valid_frac: float = 0.3,
                 pad_to: Optional[int] = None,
                 labels_pad_to: Optional[int] = None,
                 seed: Optional[int] = None,
                 device_onehot: bool = False):
        import h5py

        self.hdf5 = h5py.File(dataset_path, "r")
        keys = list(self.hdf5.keys())
        rng = np.random.default_rng(seed)
        rng.shuffle(keys)
        split = int(len(keys) * (1.0 - valid_frac))
        self.train_keys = keys[:split]
        self.valid_keys = keys[split:]
        self.max_iters = max_iters if max_iters is not None else (2 ** 62)
        self.num_epochs = num_epochs

        self.train_queue: "queue.Queue[Batch]" = queue.Queue(queue_size)
        self.valid_queue: "queue.Queue[Batch]" = queue.Queue(queue_size)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._iterations = 0
        self._worker_cfg = dict(batch_size=batch_size, sample_lengths=sample_lengths,
                                num_levels=num_levels, pad_to=pad_to,
                                labels_pad_to=labels_pad_to, device_onehot=device_onehot)
        self._threads = []
        for w in range(num_workers):
            for i, (split_keys, q) in enumerate(((self.train_keys, self.train_queue),
                                                 (self.valid_keys, self.valid_queue))):
                t = threading.Thread(
                    target=self._producer,
                    args=(split_keys, q, np.random.default_rng(
                        None if seed is None else seed + 1000 + 2 * w + i), i == 0),
                    daemon=True)
                t.start()
                self._threads.append(t)

    def _producer(self, keys, q, rng, counted=True):
        # only train production consumes the max_iters budget (the
        # reference's one counter, loaders.py:67-71, also counted validation
        # fills, which shortened training by ~queue_size; the JAX package
        # fixed that, and the port keeps its fix)
        while not self._stop.is_set():
            if counted:
                with self._lock:
                    if self._iterations >= self.max_iters:
                        return
                    self._iterations += 1
            batch = ecoli_worker_fn(self.hdf5, keys, rng, **self._worker_cfg)
            while not self._stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def dequeue(self, from_queue: str = "train", timeout: float = 1.0) -> Batch:
        """The next batch of the "train" or "valid" queue; StopIteration when
        it stays empty for ``timeout`` seconds."""
        q = self.train_queue if from_queue == "train" else self.valid_queue
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            raise StopIteration

    def close(self):
        """Stop and join the producer threads, then close the file."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self.hdf5.close()


class BucketedLoader:
    """Random-access loader over a *bucketed* HDF5 layout (reference
    utils/loaders.py:133-252): groups ``bucket_k`` each holding datasets
    {signals, reads, read_lengths, signal_lengths} plus meta attrs
    {num_buckets, bucket_size, signal_dim, max_read_length,
    max_signal_length}."""

    def __init__(self, dataset_path: str, num_levels: int = 256,
                 one_hot: bool = True, seed: Optional[int] = None):
        import h5py

        self.hdf5 = h5py.File(dataset_path, "r")
        self.num_levels = num_levels
        self.one_hot = one_hot
        self.rng = np.random.default_rng(seed)
        meta = self.hdf5.attrs
        self.num_buckets = int(meta.get("num_buckets", len(self.hdf5.keys())))
        self.bucket_size = int(meta["bucket_size"]) if "bucket_size" in meta else None

    def fetch(self, batch_size: int = 8) -> Batch:
        """batch_size sequences, without replacement, of one random bucket:
        (B, L, num_levels) one-hot signals, or (B, L, 1) float32 without
        one_hot."""
        bucket = self.hdf5[f"bucket_{self.rng.integers(self.num_buckets)}"]
        n = bucket["signals"].shape[0]
        idx = np.sort(self.rng.choice(n, size=min(batch_size, n), replace=False))
        sigs = np.asarray(bucket["signals"][idx])
        reads = np.asarray(bucket["reads"][idx]).astype(np.int32)
        read_lengths = np.asarray(bucket["read_lengths"][idx]).astype(np.int32)
        signal_lengths = np.asarray(bucket["signal_lengths"][idx]).astype(np.int32)
        if self.one_hot:
            signal = np.stack([one_hot_lc(s.astype(np.int64), self.num_levels) for s in sigs])
        else:
            signal = sigs.astype(np.float32)[..., None]
        return Batch(signal=signal, labels=reads, label_lengths=read_lengths,
                     signal_lengths=signal_lengths)

    def close(self):
        self.hdf5.close()
