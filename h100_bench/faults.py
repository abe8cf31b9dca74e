"""Faults planted in the program's timed path, for the tests and for the
readings the limits are set from (``calibrate.py``): each wraps a function
of the family's adapter (``port/<family>.py``) while it is planted, so that
the harness's own loops run unchanged on a broken program.

  * ``unchanged``: a train step that returns its state unchanged;
  * ``half``: a train step that leaves half of the batch out and takes the
    mean over the rest (the first half of the rows, then the same rows
    again, so the shapes hold);
  * ``alter``: each basecall string altered where it is produced (its last
    base changed)."""
from __future__ import annotations

import contextlib

import torch

from h100_bench.port import family

SWAP = {"A": "G", "G": "C", "C": "T", "T": "A"}


def _halve(batch):
    B = batch["signal"].shape[0]
    return {k: torch.cat([v[:B // 2], v[:B - B // 2]]) for k, v in batch.items()}


def _unchanged(make_step):
    def wrapped(cfg, model, tx):
        step = make_step(cfg, model, tx)
        return lambda state, batch: (state, step(state, batch)[1])
    return wrapped


def _half(make_step):
    def wrapped(cfg, model, tx):
        step = make_step(cfg, model, tx)
        return lambda state, batch: step(state, _halve(batch))
    return wrapped


def _alter(basecaller):
    def wrapped(cfg, model, mix, device):
        caller = basecaller(cfg, model, mix, device)

        def call(signal, lengths=None):
            seqs, scores = caller(signal, lengths=lengths)
            return [s[:-1] + SWAP.get(s[-1:], "A") for s in seqs], scores
        return call
    return wrapped


FAULTS = {"unchanged": ("make_step", _unchanged), "half": ("make_step", _half),
          "alter": ("basecaller", _alter)}


@contextlib.contextmanager
def planted(fault: str, family_name: str):
    """The family's adapter with the fault planted, while the block runs."""
    attr, wrap = FAULTS[fault]
    mod = family(family_name)
    original = getattr(mod, attr)
    setattr(mod, attr, wrap(original))
    try:
        yield
    finally:
        setattr(mod, attr, original)
