"""Pairwise-alignment basecall identity, copied from wavenet_speech_tpu/
decoding/alignment.py (plain numpy and Python; the port cannot import the
JAX package).

The reference scored basecalls by pasting them into EMBOSS `needle` and
reading the percent identity (RawCTCNet eval notebooks, md cells 23-33).
This is the same metric: Needleman-Wunsch global alignment with affine gaps
(Gotoh) at EMBOSS's default scoring (match +5, mismatch -4, gap open -10,
gap extend -0.5), identity = matches / alignment length.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# EMBOSS needle defaults (EDNAFULL match/mismatch, default gap penalties)
MATCH = 5.0
MISMATCH = -4.0
GAP_OPEN = 10.0
GAP_EXTEND = 0.5


def needleman_wunsch(a: Sequence, b: Sequence,
                     match: float = MATCH, mismatch: float = MISMATCH,
                     gap_open: float = GAP_OPEN,
                     gap_extend: float = GAP_EXTEND
                     ) -> Tuple[float, List, List]:
    """Global alignment with affine gaps (Gotoh). Returns
    (score, aligned_a, aligned_b) where aligned_* use None for gaps."""
    a = list(a)
    b = list(b)
    n, m = len(a), len(b)
    NEG = -1e18
    # M: ends in match/mismatch; X: gap in b (consume a); Y: gap in a
    M = np.full((n + 1, m + 1), NEG)
    X = np.full((n + 1, m + 1), NEG)
    Y = np.full((n + 1, m + 1), NEG)
    M[0, 0] = 0.0
    for i in range(1, n + 1):
        X[i, 0] = -gap_open - gap_extend * (i - 1)
    for j in range(1, m + 1):
        Y[0, j] = -gap_open - gap_extend * (j - 1)
    ptr_M = np.zeros((n + 1, m + 1), np.int8)  # 0=M,1=X,2=Y
    ptr_X = np.zeros((n + 1, m + 1), np.int8)
    ptr_Y = np.zeros((n + 1, m + 1), np.int8)

    for i in range(1, n + 1):
        ai = a[i - 1]
        for j in range(1, m + 1):
            s = match if ai == b[j - 1] else mismatch
            cands = (M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1])
            k = int(np.argmax(cands))
            M[i, j] = cands[k] + s
            ptr_M[i, j] = k

            cands = (M[i - 1, j] - gap_open, X[i - 1, j] - gap_extend,
                     Y[i - 1, j] - gap_open)
            k = int(np.argmax(cands))
            X[i, j] = cands[k]
            ptr_X[i, j] = k

            cands = (M[i, j - 1] - gap_open, X[i, j - 1] - gap_open,
                     Y[i, j - 1] - gap_extend)
            k = int(np.argmax(cands))
            Y[i, j] = cands[k]
            ptr_Y[i, j] = k

    ends = (M[n, m], X[n, m], Y[n, m])
    state = int(np.argmax(ends))
    score = float(ends[state])
    out_a: List = []
    out_b: List = []
    i, j = n, m
    while i > 0 or j > 0:
        if i == 0:
            out_a.append(None)
            out_b.append(b[j - 1])
            j -= 1
            continue
        if j == 0:
            out_a.append(a[i - 1])
            out_b.append(None)
            i -= 1
            continue
        if state == 0:
            out_a.append(a[i - 1])
            out_b.append(b[j - 1])
            state = int(ptr_M[i, j])
            i -= 1
            j -= 1
        elif state == 1:
            out_a.append(a[i - 1])
            out_b.append(None)
            state = int(ptr_X[i, j])
            i -= 1
        else:
            out_a.append(None)
            out_b.append(b[j - 1])
            state = int(ptr_Y[i, j])
            j -= 1
    return score, out_a[::-1], out_b[::-1]


def alignment_identity(pred: Sequence, truth: Sequence) -> Tuple[float, int, int]:
    """Percent identity of the global alignment (EMBOSS-style:
    matches / alignment_length). Returns (identity, matches, aln_len)."""
    if len(pred) == 0 and len(truth) == 0:
        return 1.0, 0, 0
    _, aa, bb = needleman_wunsch(pred, truth)
    matches = sum(1 for x, y in zip(aa, bb) if x is not None and x == y)
    aln_len = len(aa)
    return (matches / aln_len if aln_len else 0.0), matches, aln_len


def batch_identity(preds: Sequence[Sequence], truths: Sequence[Sequence]):
    """Mean identity over a batch of (pred, truth) pairs, with per-pair
    details — the reference's '65/89'-style reporting."""
    details = [alignment_identity(p, t) for p, t in zip(preds, truths)]
    mean = float(np.mean([d[0] for d in details])) if details else 0.0
    return mean, details
