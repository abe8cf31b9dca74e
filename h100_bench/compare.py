"""The numbers that decide ``correct``, each held to a limit from
``limits/<cell>.json``.

Training (the first steps of the state the window then trains):
  * ``loss_gap``: |program - reference| / |reference| of the first step's
    loss (the later steps' losses swing under Adamax's sign-like first
    update, PERF.md; the change after the steps is ``update_gap``'s);
  * ``grad_gap``: over the leaves, the largest gap between the norms of the
    first gradient as the optimizer gets it, over the reference's norm of
    that leaf or of the median leaf, whichever is larger;
  * ``update_gap``: the same for the norm of each leaf's change after the
    steps, over the leaves whose reference gradient is at least a thousandth
    of the median leaf's (the others move by round-off alone).

Basecalling (a sample of the answers the window returned):
  * ``logit_gap``: the largest |program - reference| over the reads'
    logits, over the read's largest |reference logit|;
  * ``string_miss``: the share of the reads whose string is not the best
    of the reference beam over the program's own logits;
  * ``score_gap``: over the reads whose string is, the 90th percentile of
    |returned score - that beam's score|, in nats (not the largest, which
    swings: two beams that agree on the best prefix may have pruned its
    ancestors' rivals at different frames, PERF.md; not the median, which
    a fault in a minority of the scores would pass).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

ALPHABET = {"A": 1, "G": 2, "C": 3, "T": 4}  # the reference's labels2strings


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss = _gap(prog["losses"][0], ref["losses"][0], abs(ref["losses"][0]))
    g_ref = ref["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    grads = [_gap(prog["grad_norms"][k], g, max(g, g_med)) for k, g in g_ref.items()]
    kept = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = float(np.median([c_ref[k] for k in kept]))
    changes = [_gap(prog["change_norms"][k], c_ref[k], max(c_ref[k], c_med)) for k in kept]
    return {"loss_gap": loss, "grad_gap": max(grads), "update_gap": max(changes)}


def leaf_detail(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict:
    """Beside a worst-leaf number: the worst leaf's gap over its own norm
    (no median floor), that leaf and its norm's share of the median leaf's,
    and the least share among the leaves kept."""
    med = float(np.median([ref[k] for k in keep]))
    own = {k: _gap(prog[k], ref[k], ref[k]) for k in keep}
    worst = max(own, key=own.get)
    return {"own_gap": own[worst], "leaf": worst, "share": ref[worst] / med,
            "least_share": min(ref[k] for k in keep) / med}


def train_detail(prog: Dict, ref: Dict) -> Dict:
    """Diagnostics of ``train_numbers`` (printed by calibrate.py, compared
    with nothing), over the leaves whose reference gradient is at least a
    thousandth of the median leaf's."""
    g_ref = ref["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    kept = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    return {"grad": leaf_detail(prog["grad_norms"], g_ref, kept),
            "update": leaf_detail(prog["change_norms"], ref["change_norms"], kept)}


def score_gaps(answers, best) -> list:
    """The score gaps, in nats, of the reads whose string is the reference
    beam's best."""
    return [abs(s - ref_score) if math.isfinite(s) else math.inf
            for (string, s), (labels, ref_score) in zip(answers, best)
            if tuple(ALPHABET.get(ch, -1) for ch in string) == tuple(labels)]


def basecall_numbers(logits: Sequence[Tuple[np.ndarray, np.ndarray]],
                     answers: Sequence[Tuple[str, float]],
                     best: Sequence[Tuple[Tuple[int, ...], float]]) -> Dict[str, float]:
    """logits[i] = (the program's, the reference's) logits of read i;
    answers[i] = the (string, score) returned; best[i] = the reference
    beam's best (labels, score) over the program's logits."""
    logit_gap = 0.0
    for lg, rl in logits:
        scale = max(float(np.abs(rl).max()), 1e-30)
        d = float(np.abs(lg - rl).max()) / scale if lg.shape == rl.shape else math.inf
        logit_gap = max(logit_gap, d if math.isfinite(d) else math.inf)
    scores = score_gaps(answers, best)
    n = len(answers)
    misses = n - len(scores)
    return {"logit_gap": logit_gap, "string_miss": misses / n if n else math.inf,
            "score_gap": float(np.percentile(scores, 90)) if scores else math.inf}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a missing or NaN number fails)."""
    return all(name in numbers and numbers[name] <= lim for name, lim in limits.items())
