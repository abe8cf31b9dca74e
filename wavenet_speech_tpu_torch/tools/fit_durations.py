"""Offline tool: nanopolish eventalign TSV -> per-5-mer Gamma duration model
(wavenet_speech_tpu/tools/fit_durations.py; reference
utils/dump_durations_from_eventalign.py:13-136). Host code on numpy and
scipy, copied from the JAX package, which the port does not import.

Streams the (potentially ~200 GB) TSV with a 3-row window, keeps the middle
event's duration when the window passes the admissibility filters, then
MLE-fits a Gamma per 5-mer and dumps a [1024, 2] NPY (col 0 = shape,
col 1 = "rate").

Note: the reference's filter function contains `pass`-instead-of-`return`
bugs that disabled all its filters; this implementation applies the
*intended* filters (documented in its docstring: position changed, no N in
kmer, event index changed, full window).

Two behaviours of the JAX tool are kept as it has them:
- ``update_all`` stores scipy's fitted *scale* in the "rate" column, while
  the k-mers left at the prior keep ``DEFAULT_RATE``, a rate: one column
  mixes rates (~587) with scales (~1/587).
- ``str2idx`` weights position k by 4^k, where ``data.gaussian_kmer.kmer_ids``
  weights the first base most, so the table's rows are not in kmer_ids'
  order.

    python -m wavenet_speech_tpu_torch.tools.fit_durations eventalign.tsv durations.npy
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict, deque

import numpy as np

DEFAULT_SHAPE = 2.461964
DEFAULT_RATE = 587.2858

NT2IDX = {"A": 0, "G": 1, "C": 2, "T": 3,
          "a": 0, "g": 1, "c": 2, "t": 3}
IDX2NT = {0: "A", 1: "G", 2: "C", 3: "T"}

EAF_HEADERS = ["contig", "position", "reference_kmer", "read_index",
               "strand", "event_index", "event_level_mean", "event_stdv",
               "event_length", "event_start_time", "model_kmer",
               "model_mean", "model_stdv", "standardized_level"]


def str2idx(kmer: str) -> int:
    """5-mer string -> index 0..1023 (reference convention: position k
    weighted by 4^k)."""
    return sum(NT2IDX[kmer[k]] * (4 ** k) for k in range(5))


def idx2str(idx: int) -> str:
    out = []
    for _ in range(5):
        out.append(IDX2NT[idx % 4])
        idx //= 4
    return "".join(out)


class DurationModel:
    def __init__(self):
        self.model_parameters = {
            k: {"shape": DEFAULT_SHAPE, "rate": DEFAULT_RATE}
            for k in range(4 ** 5)
        }
        self.samples = defaultdict(list)

    def update_all(self, min_samples: int = 3):
        from scipy import stats

        for k in range(4 ** 5):
            obs = np.asarray(self.samples[k])
            if obs.shape[0] < min_samples:
                continue  # keep the prior
            alpha, _loc, scale = stats.gamma.fit(obs)
            self.model_parameters[k]["shape"] = float(alpha)
            # scipy's scale, stored as "rate" as JAX does (module docstring)
            self.model_parameters[k]["rate"] = float(scale)

    def dump(self, path: str):
        arr = np.stack(
            [np.array([self.model_parameters[k]["shape"] for k in range(1024)]),
             np.array([self.model_parameters[k]["rate"] for k in range(1024)])],
            axis=1).astype(np.float32)
        np.save(path, arr)
        return arr


def admissible(rows) -> bool:
    """Intended filters of reference maybe_append
    (dump_durations_from_eventalign.py:70-97)."""
    if len(rows) < 3:
        return False
    kmer = rows[1]["reference_kmer"]
    if "N" in kmer or "n" in kmer:
        return False
    p0, p1, p2 = (int(r["position"]) for r in rows)
    if p0 == p1 or p1 == p2:
        return False
    e0, e1, e2 = (int(r["event_index"]) for r in rows)
    if e0 == e1 or e1 == e2:
        return False
    return True


def fit_from_tsv(tsv_path: str, npy_dump_path: str,
                 min_samples: int = 3) -> np.ndarray:
    model = DurationModel()
    with open(tsv_path, "r") as eaf:
        rdr = csv.DictReader(eaf, delimiter="\t", fieldnames=EAF_HEADERS,
                             quoting=csv.QUOTE_NONE)
        next(rdr, None)  # skip header
        window = deque(maxlen=3)
        for row in rdr:
            window.append(row)
            if admissible(window):
                model.samples[str2idx(window[1]["reference_kmer"])].append(
                    float(window[1]["event_length"]))
    model.update_all(min_samples)
    return model.dump(npy_dump_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fit per-5mer Gamma duration model from eventalign TSV")
    ap.add_argument("eventalign_file")
    ap.add_argument("npy_dump_path")
    args = ap.parse_args(argv)
    assert os.path.exists(args.eventalign_file)
    fit_from_tsv(args.eventalign_file, args.npy_dump_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
