"""Nanopolish r9.4 Gaussian 5-mer generators, copied from
wavenet_speech_tpu/data/gaussian_kmer.py (the reference's utils/
gaussian_kmer_model.py, vectorized numpy). The numpy calls run in the same
order on the same generator, so a seed gives the JAX package's batches bit
for bit.

Per sequence: sliding 5-mer extraction (keeping the reference's
generic_filter alignment, which drops 2 more valid k-mers at each end) ->
fixed or random upsampling -> per-k-mer Gaussian sampling from the r9.4
template table (the port's own copy, ``r9.4_450bps.5mer.template.npz``) ->
mu-law/one-hot (GaussianModelLoader) or raw float (RawGaussianModelLoader).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from wavenet_speech_tpu_torch.data.common import (
    Batch,
    EpochCounter,
    MuLawQuantizer,
    one_hot_lc,
    pad_stack_labels,
    pad_stack_lc,
)

DEFAULT_KMER_MODEL = os.path.join(os.path.dirname(__file__),
                                  "r9.4_450bps.5mer.template.npz")

_KMER_WEIGHTS = np.array([256, 64, 16, 4, 1], dtype=np.int64)


def kmer_ids(seq: np.ndarray, trim: int) -> np.ndarray:
    """Base-4 ids of all 5-mer windows of ``seq`` (values 1..4), dropping
    ``trim`` windows from each end: trim=2 is the Gaussian loaders'
    alignment (the reference's generic_filter output sliced [4:-4])."""
    win = np.lib.stride_tricks.sliding_window_view(seq.astype(np.int64), 5)
    ids = (win - 1) @ _KMER_WEIGHTS
    return ids[trim: len(ids) - trim] if trim else ids


def random_upsample(label_seq: np.ndarray, repeat_rate: int, rng, w: int = 2,
                    axis: int = 0) -> np.ndarray:
    """Repeat each element a random number of times in
    [max(repeat_rate - w, 1), repeat_rate + w)."""
    num = rng.integers(max(repeat_rate - w, 1), repeat_rate + w, size=label_seq.shape)
    return np.repeat(label_seq, num, axis=axis)


class _GaussianBase:
    def __init__(self, max_iters, num_epochs, epoch_size, kmer_model_path,
                 batch_size, upsampling, random_upsample_, lengths, seed):
        self.counter_ = EpochCounter(max_iters, num_epochs, epoch_size)
        self.batch_size = batch_size
        self.min_length, self.max_length = lengths
        self.upsampling = upsampling
        self.random_upsample = random_upsample_
        self.rng = np.random.default_rng(seed)
        npz = np.load(kmer_model_path or DEFAULT_KMER_MODEL)
        self.kmer_means = npz["means"]
        self.kmer_stdvs = npz["stdvs"]
        self.num_kmers = 4 ** 5

    def _picoamps(self, seq: np.ndarray) -> np.ndarray:
        ks = kmer_ids(seq, trim=2)
        # the reference's quirk: upsampling <= 1 skips the branch, so
        # random_upsample is ignored at upsampling 1
        if self.upsampling > 1:
            if self.random_upsample:
                ks = random_upsample(ks, self.upsampling, self.rng)
            else:
                ks = np.repeat(ks, self.upsampling)
        return self.rng.normal(self.kmer_means[ks], self.kmer_stdvs[ks])

    def _sample_seqs(self):
        lengths = self.rng.integers(self.min_length, self.max_length, size=self.batch_size)
        return [self.rng.integers(1, 5, size=k).astype(np.int32) for k in lengths]

    @property
    def max_signal_length(self) -> int:
        """(max_length - 1 - 8) k-mers (the longest sequence less the 4 + 4
        windows trimmed), times upsampling (+1 with random upsampling)."""
        n_kmers = max(self.max_length - 1 - 8, 0)
        per = (self.upsampling + 1) if self.random_upsample else self.upsampling
        return n_kmers * max(per, 1)

    @property
    def max_label_length(self) -> int:
        return self.max_length - 1

    def _batch(self, seqs, signals) -> Batch:
        self.counter_.tick()
        return Batch(signal=pad_stack_lc(signals, self.pad_to),
                     labels=pad_stack_labels(seqs, self.labels_pad_to),
                     label_lengths=np.array([len(s) for s in seqs], np.int32),
                     signal_lengths=np.array([s.shape[0] for s in signals], np.int32))

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return self.fetch()


class GaussianModelLoader(_GaussianBase):
    """The mu-law quantized, one-hot variant (num_levels channels)."""

    def __init__(self, max_iters, num_epochs, epoch_size,
                 kmer_model_path: Optional[str] = None, batch_size: int = 1,
                 num_levels: int = 256, upsampling: int = 3,
                 random_upsample: bool = False, lengths: Tuple[int, int] = (20, 30),
                 pad_to: Optional[int] = None, labels_pad_to: Optional[int] = None,
                 seed: Optional[int] = None):
        super().__init__(max_iters, num_epochs, epoch_size, kmer_model_path,
                         batch_size, upsampling, random_upsample, lengths, seed)
        self.num_levels = num_levels
        self.quantizer = MuLawQuantizer(num_levels)
        self.pad_to, self.labels_pad_to = pad_to, labels_pad_to

    @property
    def signal_channels(self) -> int:
        return self.num_levels

    def fetch(self) -> Batch:
        self.counter_.maybe_stop()
        seqs = self._sample_seqs()
        return self._batch(seqs, [one_hot_lc(self.quantizer(self._picoamps(s)),
                                             self.num_levels) for s in seqs])


class RawGaussianModelLoader(_GaussianBase):
    """The raw pico-amp variant: one float32 channel."""

    def __init__(self, max_iters, num_epochs, epoch_size,
                 kmer_model_path: Optional[str] = None, batch_size: int = 1,
                 upsampling: int = 3, random_upsample: bool = False,
                 lengths: Tuple[int, int] = (20, 30), pad_to: Optional[int] = None,
                 labels_pad_to: Optional[int] = None, seed: Optional[int] = None):
        super().__init__(max_iters, num_epochs, epoch_size, kmer_model_path,
                         batch_size, upsampling, random_upsample, lengths, seed)
        self.pad_to, self.labels_pad_to = pad_to, labels_pad_to

    @property
    def signal_channels(self) -> int:
        return 1

    def fetch(self) -> Batch:
        self.counter_.maybe_stop()
        seqs = self._sample_seqs()
        return self._batch(seqs, [self._picoamps(s).astype(np.float32)[:, None]
                                  for s in seqs])
