"""Synthetic triangular-pore-model generator, copied from
wavenet_speech_tpu/data/pore_model.py (the reference's utils/pore_model.py:
12-189, vectorized numpy). The numpy calls run in the same order on the
same generator, so a seed gives the JAX package's batches bit for bit.

Pipeline per sequence: random bases {1..4} -> per-base pico-amp lookup ->
correlation with a triangular window of width pore_width (the reference uses
scipy.ndimage.generic_filter with mode='constant'; we reproduce its centered
window alignment, including the even-width left bias) -> sample_rate x repeat
-> white noise -> mu-law quantize + one-hot, or raw float.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from wavenet_speech_tpu_torch.data.common import (
    Batch,
    EpochCounter,
    MuLawQuantizer,
    interleave_zeros,
    one_hot_lc,
    pad_stack_lc,
    pad_stack_labels,
)

# default nucleotide -> pico-amp map (reference utils/pore_model.py:11)
DEFAULT_CURRENTS: Dict[int, float] = {1: 51.0, 2: 22.0, 3: 103.0, 4: 115.0}


def triang_window(width: int) -> np.ndarray:
    """scipy.signal.triang(width) without the scipy dependency."""
    n = np.arange(1, (width + 1) // 2 + 1)
    if width % 2 == 0:
        w = (2 * n - 1.0) / width
        return np.concatenate([w, w[::-1]])
    w = 2 * n / (width + 1.0)
    return np.concatenate([w, w[-2::-1]])


def centered_window_filter(x: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Same-length sliding dot product with zero boundary, aligned like
    scipy.ndimage.generic_filter: output[i] = dot(x[i-w//2 : i+(w+1)//2], win)
    (left-biased for even widths)."""
    w = len(window)
    left, right = w // 2, (w - 1) // 2
    xp = np.pad(x, (left, right), mode="constant")
    windows = np.lib.stride_tricks.sliding_window_view(xp, w)
    return windows @ window


class PoreModelLoader:
    """Drop-in capability match for the reference PoreModelLoader; emits NLC
    numpy batches.  `pad_to`/`labels_pad_to` give static output shapes for
    jit-friendliness (None = reference behavior: pad to batch max)."""

    def __init__(
        self,
        max_iters: int,
        num_epochs: int,
        epoch_size: int,
        batch_size: int = 1,
        num_levels: int = 256,
        lengths: Tuple[int, int] = (20, 30),
        pore_width: int = 4,
        sample_rate: int = 3,
        currents_dict: Optional[Dict[int, float]] = None,
        sample_noise: float = 3.0,
        interleave_blanks: bool = False,
        raw_signal: bool = False,
        pad_to: Optional[int] = None,
        labels_pad_to: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.counter_ = EpochCounter(max_iters, num_epochs, epoch_size)
        self.batch_size = batch_size
        self.num_levels = num_levels
        self.min_length, self.max_length = lengths
        self.pore_width = pore_width
        self.sample_rate = sample_rate
        self.currents = dict(currents_dict or DEFAULT_CURRENTS)
        self.sample_noise = sample_noise
        self.interleave_blanks = interleave_blanks
        self.raw_signal = raw_signal
        self.quantizer = MuLawQuantizer(num_levels)
        self.rng = np.random.default_rng(seed)
        self._currents_lut = np.zeros(5, dtype=np.float32)
        for k, v in self.currents.items():
            self._currents_lut[k] = v
        self._window = triang_window(pore_width)
        if pad_to is None and labels_pad_to is None:
            self.pad_to = None
            self.labels_pad_to = None
        else:
            self.pad_to = pad_to if pad_to is not None else self.max_signal_length
            self.labels_pad_to = (
                labels_pad_to if labels_pad_to is not None else self.max_label_length
            )

    # --- static shape bounds (for jit-stable batches) ---
    @property
    def max_signal_length(self) -> int:
        return (self.max_length - 1) * self.sample_rate

    @property
    def max_label_length(self) -> int:
        n = self.max_length - 1
        return 2 * n if self.interleave_blanks else n

    @property
    def signal_channels(self) -> int:
        return 1 if self.raw_signal else self.num_levels

    # --- reference math, vectorized ---
    def pore_model_fn(self, sequence: np.ndarray) -> np.ndarray:
        pico = self._currents_lut[sequence]
        pa = centered_window_filter(pico, self._window)
        noiseless = np.repeat(pa, self.sample_rate)
        return noiseless + self.rng.normal(0.0, self.sample_noise, noiseless.shape)

    def convert_to_signal(self, seq: np.ndarray) -> np.ndarray:
        """-> (L, C) float32 (C=1 raw, C=num_levels one-hot)."""
        pa = self.pore_model_fn(seq)
        if self.raw_signal:
            return pa.astype(np.float32)[:, None]
        return one_hot_lc(self.quantizer(pa), self.num_levels)

    def fetch(self) -> Batch:
        self.counter_.maybe_stop()
        lengths = self.rng.integers(self.min_length, self.max_length,
                                    size=self.batch_size)
        seqs = [self.rng.integers(1, 5, size=k).astype(np.int32) for k in lengths]
        signals = [self.convert_to_signal(s) for s in seqs]
        if self.interleave_blanks:
            seqs = [interleave_zeros(s) for s in seqs]
        self.counter_.tick()
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
