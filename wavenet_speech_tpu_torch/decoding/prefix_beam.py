"""CTC prefix beam search on the host, copied from wavenet_speech_tpu/
decoding/prefix_beam.py (plain numpy and Python): the correctness reference
of the batched beam (``decoding.ctc_beam_device``) and the 'python' engine
of ``facade.Decoder``.

Standard prefix beam search (Hannun et al. 2014) in log space: each beam is
a blank-collapsed prefix carrying (log p ending in blank, log p ending in
non-blank); at every frame each prefix is extended by blank, by a repeat and
by every label, equal prefixes are merged, and the top ``beam_width`` are
kept by total probability.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

NEG_INF = -float("inf")


def _logsumexp(*xs: float) -> float:
    m = max(xs)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


def prefix_beam_search(log_probs: np.ndarray, beam_width: int = 7,
                       blank: int = 0, length: Optional[int] = None
                       ) -> List[Tuple[Tuple[int, ...], float]]:
    """Decode one sequence.

    Args:
      log_probs: (T, C) log probabilities.
      beam_width: number of beams kept per step.
      blank: blank label id.
      length: valid frame count (default T).
    Returns: list of (prefix tuple, log prob) sorted best-first.
    """
    T, C = log_probs.shape
    T = T if length is None else int(length)
    # beams: prefix -> (log_p_blank, log_p_nonblank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(T):
        lp = log_probs[t]
        new_beams: dict = {}

        def add(prefix, pb, pnb):
            if prefix in new_beams:
                opb, opnb = new_beams[prefix]
                new_beams[prefix] = (_logsumexp(opb, pb), _logsumexp(opnb, pnb))
            else:
                new_beams[prefix] = (pb, pnb)

        for prefix, (pb, pnb) in beams.items():
            total = _logsumexp(pb, pnb)
            # extend by blank: prefix unchanged, ends in blank
            add(prefix, total + lp[blank], NEG_INF)
            for c in range(C):
                if c == blank:
                    continue
                lpc = lp[c]
                if prefix and prefix[-1] == c:
                    # repeat of last symbol: collapses unless separated by blank
                    add(prefix, NEG_INF, pnb + lpc)
                    add(prefix + (c,), NEG_INF, pb + lpc)
                else:
                    add(prefix + (c,), NEG_INF, total + lpc)

        scored = sorted(new_beams.items(),
                        key=lambda kv: -_logsumexp(*kv[1]))
        beams = dict(scored[:beam_width])

    out = [(p, _logsumexp(pb, pnb)) for p, (pb, pnb) in beams.items()]
    out.sort(key=lambda kv: -kv[1])
    return out


def beam_search_decode(logits: np.ndarray, beam_width: int = 7,
                       blank: int = 0, lengths: Optional[np.ndarray] = None,
                       log_input: bool = False):
    """Batched wrapper: (B, T, C) logits (softmaxed internally unless
    log_input) -> (labels list, scores list) best-beam per sequence —
    the CTCBeamDecoder-style API."""
    logits = np.asarray(logits, dtype=np.float64)
    if not log_input:
        m = logits.max(axis=-1, keepdims=True)
        logits = logits - m
        logits = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
    results, scores = [], []
    for b in range(logits.shape[0]):
        length = None if lengths is None else int(lengths[b])
        hyps = prefix_beam_search(logits[b], beam_width, blank, length)
        best, score = hyps[0]
        results.append(np.array(best, dtype=np.int32))
        scores.append(score)
    return results, scores
