"""Realistic raw-signal generator, copied from wavenet_speech_tpu/data/
raw_signal.py (reference utils/raw_signal_generator.py): reads drawn from
a reference genome in HDF5 (``/<contig>/contig`` datasets of bases 1..4),
per-5-mer durations from a Gamma(shape, rate) x sample_rate model,
per-5-mer Gaussian pico-amps from the r9.4 template table. Host-side
numpy; the numpy calls run in the JAX module's order on one generator, so
a seed gives its batches bit for bit.

``h5py`` is imported in the constructor only (the card's machine has
none).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from wavenet_speech_tpu_torch.data.common import Batch, pad_stack_labels, pad_stack_lc
from wavenet_speech_tpu_torch.data.gaussian_kmer import DEFAULT_KMER_MODEL, kmer_ids

# the reference's hard-coded MLE fit of the r9.4 duration model
# (raw_signal_generator.py:84-86)
DEFAULT_DURATION_SHAPE = 2.461964
DEFAULT_DURATION_RATE = 587.2858


def gamma_upsample(label_seq, gamma_shape, gamma_rate, srate, rng):
    """Repeat each label Gamma(shape, 1/rate) * srate times, at least once
    (reference raw_signal_generator.py:189-203)."""
    num = (rng.gamma(gamma_shape, 1.0 / gamma_rate, size=label_seq.shape) * srate
           ).astype(np.int32)
    num = np.maximum(num, 1)
    return np.repeat(label_seq, num, axis=0), num


def sample_from_pmf(pmf: np.ndarray, rng, size: int = 1) -> np.ndarray:
    return rng.choice(np.arange(pmf.shape[0]), p=pmf, size=size)


class RawSignalGenerator:
    """Emits Batch(signal (B, L, 1), labels, label_lengths, signal_lengths).

    Arguments of the reference constructor (raw_signal_generator.py:37-58):
    kmer_model (NPZ path, None for the r9.4 table), reference_hdf (the
    genome), read_length_model (NPY path of a PMF, or an (lo, hi) tuple:
    uniform over [lo, hi)), sample_rate, batch_size, dura_shape/dura_rate
    overrides; and pad_to / labels_pad_to, fixed signal and label widths.
    """

    def __init__(self, kmer_model: Optional[str], reference_hdf: str,
                 read_length_model: Union[str, Tuple[int, int]],
                 sample_rate: float = 800.0, batch_size: int = 1,
                 dura_shape: Optional[float] = None,
                 dura_rate: Optional[float] = None,
                 pad_label: int = 0,
                 pad_to: Optional[int] = None,
                 labels_pad_to: Optional[int] = None,
                 seed: Optional[int] = None):
        import h5py  # host-side IO, imported here only

        if pad_label != 0:
            raise ValueError("padding labels other than 0 are unsupported")
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.duration_shape = DEFAULT_DURATION_SHAPE if dura_shape is None else dura_shape
        self.duration_rate = DEFAULT_DURATION_RATE if dura_rate is None else dura_rate
        self.rng = np.random.default_rng(seed)
        self.pad_to = pad_to
        self.labels_pad_to = labels_pad_to

        npz = np.load(kmer_model or DEFAULT_KMER_MODEL)
        self.kmer_means = npz["means"]
        self.kmer_stdvs = npz["stdvs"]

        self.reference = h5py.File(reference_hdf, "r")
        self.contigs = list(self.reference.keys())

        if isinstance(read_length_model, tuple):
            lo, hi = read_length_model
            pmf = np.zeros(hi)
            pmf[lo:hi] = 1.0
        else:
            pmf = np.load(read_length_model)
        self.read_lengths = pmf / pmf.sum()

    def close(self):
        self.reference.close()

    def fetch_from_reference(self, L: int) -> np.ndarray:
        ctg = self.reference[self.contigs[self.rng.integers(len(self.contigs))]]["contig"]
        if ctg.shape[0] <= L:  # a short contig is returned whole
            return np.asarray(ctg[:])
        pos = self.rng.integers(ctg.shape[0] - L)
        return np.asarray(ctg[pos: pos + L])

    def gaussian_model_fn(self, sequence: np.ndarray) -> np.ndarray:
        ks = kmer_ids(sequence, trim=0)  # the reference's [2:-2] == every full window
        ks, _ = gamma_upsample(ks, self.duration_shape, self.duration_rate,
                               self.sample_rate, self.rng)
        return self.rng.normal(self.kmer_means[ks], self.kmer_stdvs[ks])

    def fetch(self) -> Batch:
        seq_lengths = sample_from_pmf(self.read_lengths, self.rng, size=self.batch_size)
        seqs = [self.fetch_from_reference(int(k)).astype(np.int32) for k in seq_lengths]
        signals = [self.gaussian_model_fn(s).astype(np.float32)[:, None] for s in seqs]
        return Batch(
            signal=pad_stack_lc(signals, self.pad_to),
            labels=pad_stack_labels(seqs, self.labels_pad_to),
            label_lengths=np.array([len(s) for s in seqs], np.int32),
            signal_lengths=np.array([s.shape[0] for s in signals], np.int32),
        )

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return self.fetch()
