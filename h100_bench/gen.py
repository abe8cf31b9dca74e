"""The benchmark's traffic generators, in plain numpy.

A traffic file (``traffic/<mix>.json``) names one generator here and gives
its parameters; ``make(mix, seed)`` returns the pool of host batches the
loop cycles through. The same seed gives the same pool.

Every seed gets the same set of sizes, in another order: the lengths of a
pool are spread evenly over the mix's range and then shuffled, so that two
seeds differ in the data and the order, not in the amount of work.

  * ``uniform_levels``: bench.py:126-135 — B reads of L uniform levels and
    S labels from {1..bases}; shipped as (B, L) int32 levels, which the
    train step turns one-hot on the card.
  * ``raw_gauss``: the r9.4 Gaussian 5-mer generator of the port's
    ``data/gaussian_kmer.py`` (raw pico-amps, random upsampling) with the
    padding of ``examples/gaussian_eval.py::make_loader``; the table is the
    copy in ``data/``.
  * ``onehot_reads``: reads of uniform levels, one-hot (B, L_max, levels)
    float32, with their lengths: what a caller hands ``Basecaller``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

R94_TABLE = Path(__file__).resolve().parent / "data" / "r9.4_450bps.5mer.template.npz"
_KMER_WEIGHTS = np.array([256, 64, 16, 4, 1], dtype=np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


def spread(lo: int, hi: int, n: int, gen: np.random.Generator) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi), shuffled."""
    return gen.permutation(lo + (np.arange(n) * (hi - lo)) // n)


def uniform_levels(mix: Dict, gen: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    B, L, S = mix["batch"], mix["length"], mix["labels"]
    pool = []
    for _ in range(mix["pool"]):
        pool.append({
            "signal": gen.integers(0, mix["levels"], size=(B, L)).astype(np.int32),
            "labels": gen.integers(1, mix["bases"] + 1, size=(B, S)).astype(np.int32),
            "label_lengths": np.full((B,), S, np.int32),
            "signal_lengths": np.full((B,), L, np.int32)})
    return pool


def _kmer_ids(seq: np.ndarray) -> np.ndarray:
    """Base-4 ids of the 5-mer windows of seq (values 1..4), two windows
    dropped at each end (the reference's generic_filter alignment)."""
    win = np.lib.stride_tricks.sliding_window_view(seq.astype(np.int64), 5)
    ids = (win - 1) @ _KMER_WEIGHTS
    return ids[2: len(ids) - 2]


def raw_gauss(mix: Dict, gen: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    table = np.load(R94_TABLE)
    means, stdvs = table["means"], table["stdvs"]
    B, rate, w = mix["batch"], mix["upsampling"], mix["upsampling_spread"]
    counts = spread(mix["bases_min"], mix["bases_max"], B * mix["pool"], gen)
    pool = []
    for i in range(mix["pool"]):
        seqs, sigs = [], []
        for n in counts[i * B:(i + 1) * B]:
            seq = gen.integers(1, 5, size=int(n)).astype(np.int32)
            ks = _kmer_ids(seq)
            ks = np.repeat(ks, gen.integers(max(rate - w, 1), rate + w, size=ks.shape))
            seqs.append(seq)
            sigs.append(gen.normal(means[ks], stdvs[ks]).astype(np.float32))
        signal = np.zeros((B, mix["pad_to"], 1), np.float32)
        labels = np.zeros((B, mix["labels_pad_to"]), np.int32)
        for b, (seq, sig) in enumerate(zip(seqs, sigs)):
            signal[b, :len(sig), 0] = sig
            labels[b, :len(seq)] = seq
        pool.append({"signal": signal, "labels": labels,
                     "label_lengths": np.array([len(s) for s in seqs], np.int32),
                     "signal_lengths": np.array([len(s) for s in sigs], np.int32)})
    return pool


def onehot_reads(mix: Dict, gen: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    B, C = mix["batch"], mix["levels"]
    lengths = spread(mix["length_min"], mix["length_max"] + 1, B * mix["pool"], gen)
    pool = []
    for i in range(mix["pool"]):
        lens = lengths[i * B:(i + 1) * B].astype(np.int32)
        levels = gen.integers(0, C, size=(B, int(lens.max()))).astype(np.int32)
        levels[np.arange(levels.shape[1])[None, :] >= lens[:, None]] = -1
        signal = np.zeros(levels.shape + (C,), np.float32)
        b, t = np.nonzero(levels >= 0)
        signal[b, t, levels[b, t]] = 1.0
        pool.append({"signal": signal, "levels": levels, "signal_lengths": lens})
    return pool


GENERATORS = {"uniform_levels": uniform_levels, "raw_gauss": raw_gauss,
              "onehot_reads": onehot_reads}


def make(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of host batches of a traffic mix for a seed."""
    return GENERATORS[mix["generator"]](mix, rng(seed, 0))
