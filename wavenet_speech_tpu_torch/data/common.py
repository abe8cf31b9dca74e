"""The data layer's shared pieces, copied from wavenet_speech_tpu/data/
common.py (the port cannot import the JAX package): the alphabet, the batch
container, the mu-law quantiser, one-hot encoding, padding to static
shapes, and the epoch bookkeeping. Host-side numpy; batches reach the
device through data/prefetch.py."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# nucleotide alphabet used throughout the reference: 0 = CTC blank / pad,
# 1..4 = A,G,C,T (reference modules/sequence_decoders.py:26)
ALPHABET = {0: "", 1: "A", 2: "G", 3: "C", 4: "T"}


@dataclasses.dataclass
class Batch:
    """One training batch in NLC layout.

    signal:         (B, L, C) float32 — one-hot levels or raw waveform (C=1)
    labels:         (B, S) int32 dense targets, 0-padded
    label_lengths:  (B,) int32
    signal_lengths: (B,) int32 — valid frame counts in `signal`
    """

    signal: np.ndarray
    labels: np.ndarray
    label_lengths: np.ndarray
    signal_lengths: np.ndarray

    @property
    def flat_labels(self) -> np.ndarray:
        """The targets concatenated, int32 (warp-ctc's convention, used by
        the reference loaders, utils/pore_model.py:130-165)."""
        return np.concatenate(
            [self.labels[b, : self.label_lengths[b]] for b in range(len(self.labels))]
        ).astype(np.int32) if len(self.labels) else np.zeros((0,), np.int32)


class MuLawQuantizer:
    """mu-law companding + uniform levels, exactly the reference's law
    (utils/pore_model.py:58-62,78-85): normalize by (x-mean)/(max-min),
    mu-law with mu=num_levels, then np.digitize against num_levels bins in
    [-1, 1].

    Note np.digitize returns indices in [0, num_levels]; the reference
    one-hots the result into a num_levels-sized axis, so level num_levels
    would overflow — in practice mu-law output never reaches +1.0 exactly.
    We clip to num_levels-1 for safety (behavior identical on real data).
    """

    def __init__(self, num_levels: int):
        self.num_levels = num_levels
        self.mu = float(num_levels)
        self.levels = np.linspace(-1.0, 1.0, num=num_levels)

    def __call__(self, fseq: np.ndarray) -> np.ndarray:
        span = np.amax(fseq) - np.amin(fseq)
        normalized = (fseq - np.mean(fseq)) / span
        mapped = (
            np.sign(normalized)
            * np.log1p(self.mu * np.abs(normalized))
            / np.log1p(self.mu)
        )
        return np.clip(np.digitize(mapped, self.levels), 0, self.num_levels - 1)


def one_hot_lc(dseq: np.ndarray, num_levels: int) -> np.ndarray:
    """(L,) int -> (L, num_levels) float32 one-hot (NLC layout; the
    reference's one_hot_fn emits (C, L), utils/pore_model.py:88-96)."""
    out = np.zeros((dseq.shape[0], num_levels), dtype=np.float32)
    out[np.arange(dseq.shape[0]), dseq] = 1.0
    return out


def pad_stack_lc(sigs, pad_to: Optional[int] = None) -> np.ndarray:
    """Zero-pad a list of (L_i, C) arrays on the length axis and stack to
    (B, max_L, C)."""
    max_len = max(s.shape[0] for s in sigs)
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to={pad_to} < longest signal {max_len}")
        max_len = pad_to
    out = np.zeros((len(sigs), max_len, sigs[0].shape[1]), dtype=np.float32)
    for i, s in enumerate(sigs):
        out[i, : s.shape[0]] = s
    return out


def pad_stack_labels(seqs, pad_to: Optional[int] = None) -> np.ndarray:
    """0-pad integer label sequences to (B, max_S) int32."""
    max_len = max((s.shape[0] for s in seqs), default=0)
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to={pad_to} < longest label seq {max_len}")
        max_len = pad_to
    out = np.zeros((len(seqs), max_len), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : s.shape[0]] = s
    return out


def interleave_zeros(seq: np.ndarray) -> np.ndarray:
    """Put a 0 (blank) after each label (reference utils/pore_model.py:185-189)."""
    zeros = np.zeros_like(seq)
    return np.ravel(np.column_stack((seq, zeros)))


class EpochCounter:
    """max_iters / num_epochs / epoch_size bookkeeping; raises StopIteration
    like the reference loaders (utils/pore_model.py:175-183)."""

    def __init__(self, max_iters: int, num_epochs: int, epoch_size: int):
        self.max_iters = max_iters
        self.num_epochs = num_epochs
        self.epoch_size = epoch_size
        self.counter = 0
        self.epochs = 0

    def maybe_stop(self):
        if self.epochs == self.num_epochs or self.counter == self.max_iters:
            raise StopIteration

    def tick(self):
        self.counter += 1
        if self.counter != 0 and self.counter % self.epoch_size == 0:
            self.epochs += 1
