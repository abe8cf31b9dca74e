"""CTC prefix beam search (Hannun et al. 2014) in float64 Python, the
reference of a basecall's string and score.

Each beam is a blank-collapsed prefix with the log-probabilities of its
paths ending in blank (pb) and in a label (pnb). At every frame a prefix
stays by a blank or by repeating its last label, and extends by every
label (a repeat of its last label only from pb); equal prefixes merge;
the beam_width most probable are kept. A prefix is a node of a tree
(parent, label), so that extending one costs no copy."""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

NEG = -math.inf


def _lse(a: float, b: float) -> float:
    if a == NEG:
        return b
    if b == NEG:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def prefix_beam(log_probs: np.ndarray, beam_width: int, blank: int = 0
                ) -> List[Tuple[Tuple[int, ...], float]]:
    """log_probs (T, C) float64 -> [(prefix, log p)] of the final beams,
    best first."""
    T, C = log_probs.shape
    parent, label = [-1], [-1]       # node 0: the empty prefix
    child = {}

    def extend(node: int, c: int) -> int:
        key = (node, c)
        n = child.get(key)
        if n is None:
            n = child[key] = len(parent)
            parent.append(node)
            label.append(c)
        return n

    beams = {0: (0.0, NEG)}
    for t in range(T):
        lp = log_probs[t].tolist()
        new = {}

        def add(node, pb, pnb):
            old = new.get(node)
            new[node] = (pb, pnb) if old is None else (_lse(old[0], pb), _lse(old[1], pnb))

        for node, (pb, pnb) in beams.items():
            tot = _lse(pb, pnb)
            add(node, tot + lp[blank], NEG)
            last = label[node]
            for c in range(C):
                if c == blank:
                    continue
                if c == last:
                    add(node, NEG, pnb + lp[c])
                    add(extend(node, c), NEG, pb + lp[c])
                else:
                    add(extend(node, c), NEG, tot + lp[c])
        ranked = sorted(new.items(), key=lambda kv: -_lse(*kv[1]))
        beams = dict(ranked[:beam_width])

    def labels_of(node):
        out = []
        while node > 0:
            out.append(label[node])
            node = parent[node]
        return tuple(reversed(out))

    out = [(labels_of(n), _lse(pb, pnb)) for n, (pb, pnb) in beams.items()]
    return sorted(out, key=lambda kv: -kv[1])


def log_softmax64(logits: np.ndarray) -> np.ndarray:
    x = np.asarray(logits, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))
