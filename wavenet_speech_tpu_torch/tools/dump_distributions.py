"""Offline tool: FASTA reference -> integer-label HDF5 genome, plus
empirical per-read distributions from a reads HDF5
(wavenet_speech_tpu/tools/dump_distributions.py; reference
utils/dump_distributions.py:25-96). Host code on numpy and h5py, copied
from the JAX package, which the port does not import; h5py is imported
inside the functions that write or read HDF5, so the module imports where
h5py is missing.

Outputs in --outdir:
  reference.hdf5     — one group per contig with an int32 'contig' dataset
                       (A,G,C,T -> 1,2,3,4; N's dropped), the layout
                       data.raw_signal.RawSignalGenerator consumes
  sample_counts.npy  — histogram of per-event sample counts
  read_lengths.npy   — histogram of read lengths

Uses a built-in FASTA parser (no pysam dependency).

    python -m wavenet_speech_tpu_torch.tools.dump_distributions \\
        --reference ref.fa [--reads reads.hdf5] [--outdir out/]
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import numpy as np

NT_DICT = {"A": 1, "G": 2, "C": 3, "T": 4,
           "a": 1, "g": 2, "c": 3, "t": 4}


def string_to_array(nts: str) -> np.ndarray:
    """ACGT/acgt -> int32 labels, dropping anything else (N's)."""
    return np.fromiter((NT_DICT[ch] for ch in nts if ch in NT_DICT),
                       dtype=np.int32)


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (contig_name, sequence) pairs from a FASTA file."""
    name = None
    chunks = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def dump_reference(reference_fasta: str, out_path: str) -> None:
    import h5py

    with h5py.File(out_path, "w") as ref_hdf:
        for ctg, seq in read_fasta(reference_fasta):
            arr = string_to_array(seq)
            grp = ref_hdf.create_group(ctg.strip())
            dset = grp.create_dataset("contig", data=arr)
            dset.attrs["size"] = arr.shape[0]


def dump_read_statistics(reads_path: str, outdir: str) -> None:
    import h5py

    sample_counts: Dict[int, int] = defaultdict(int)
    read_lengths: Dict[int, int] = defaultdict(int)
    max_count = max_length = 0
    with h5py.File(reads_path, "r") as hf:
        for read in hf.keys():
            raw_samples = hf[read]["raw"]["samples"]
            for arr in raw_samples:
                n = np.asarray(arr).shape[0]
                sample_counts[n] += 1
                max_count = max(max_count, n)
            read_size = hf[read]["reference"].shape[0]
            read_lengths[read_size] += 1
            max_length = max(max_length, read_size)
    counts = np.array([sample_counts[k] for k in range(1, max_count + 1)],
                      np.int32)
    lengths = np.array([read_lengths[k] for k in range(1, max_length + 1)],
                       np.int32)
    np.save(os.path.join(outdir, "sample_counts.npy"), counts)
    np.save(os.path.join(outdir, "read_lengths.npy"), lengths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dump reference genome + read statistics")
    ap.add_argument("--reads", help="reads HDF5 (optional)")
    ap.add_argument("--reference", required=True, help="reference FASTA")
    ap.add_argument("--outdir", default="./")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    dump_reference(args.reference,
                   os.path.join(args.outdir, "reference.hdf5"))
    if args.reads:
        dump_read_statistics(args.reads, args.outdir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
