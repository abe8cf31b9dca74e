"""Label-synchronous beam search (wavenet_speech_tpu/decoding/labelsync.py):
the reference's OpenNMT-style Beam / BeamSearchDecoder (modules/
beam.py:17-130, modules/sequence_decoders.py:45-112), which decodes what
the autoregressive decoders emit. It is not CTC prefix beam search.

Kept as the reference has it: the additive score update over softmax
PROBABILITIES (beam.py:113-118), the first step that lets only beam 0
propose (beam.py:115-117), and the stop once the top beam emits </s>.

``_advance_scan`` is JAX's ``lax.scan`` as a loop over frames on the
logits' device, the batch at once: a top-k over W x C a frame. The
backpointer walk runs on the host (``Beam``, numpy).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wavenet_speech_tpu_torch.utils.device import resolve_device

DEFAULT_BEAM_MAP = {"<pad>": 0, "<s>": 5, "</s>": 6}


def _advance_scan(probs: torch.Tensor, beam_width: int, end_label: int):
    """probs (B, T, C) label distributions. Returns the per-step scores
    (B, T, W), prev_ks (B, T, W), next_ys (B, T, W) and done_after (B, T);
    a beam set is frozen (its scores carried, self-backpointers, label 0)
    from the step after its top beam emitted </s>."""
    B, T, C = probs.shape
    W, dev = beam_width, probs.device
    scores = torch.zeros((B, W), dtype=probs.dtype, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    first_mask = torch.zeros((W, C), dtype=probs.dtype, device=dev)
    first_mask[1:] = -1e9            # step 0: only beam 0 proposes
    self_k = torch.arange(W, device=dev).expand(B, W)
    out = {k: [] for k in ("scores", "prev_k", "next_y", "done")}
    for t in range(T):
        beam_dist = probs[:, t, None, :] + scores[:, :, None]          # (B, W, C)
        if t == 0:
            beam_dist = beam_dist + first_mask
        best_scores, best_ids = torch.topk(beam_dist.reshape(B, W * C), W, dim=1)
        prev_k = torch.div(best_ids, C, rounding_mode="floor")
        next_y = best_ids - prev_k * C
        frozen = done[:, None]
        scores = torch.where(frozen, scores, best_scores)
        prev_k = torch.where(frozen, self_k, prev_k)
        next_y = torch.where(frozen, 0, next_y)
        done = done | (next_y[:, 0] == end_label)
        for k, v in zip(out, (scores, prev_k, next_y, done)):
            out[k].append(v)
    return tuple(torch.stack(v, dim=1) for v in out.values())


class Beam:
    """Host-side view of one sequence's beam (API of reference
    modules/beam.py: sort_best / get_best / get_hyp)."""

    def __init__(self, scores, prev_ks, next_ys, done_after):
        self.scores = np.asarray(scores[-1])
        self.prev_Ks = np.asarray(prev_ks)
        self.next_Ys = np.asarray(next_ys)
        done_after = np.asarray(done_after)
        self.done = bool(done_after[-1])
        # beams freeze once the top beam emits </s> (reference
        # sequence_decoders.py:101-103); later steps are no-op rows, so the
        # hypothesis walk starts at the stop
        firsts = np.flatnonzero(done_after)
        self.n_steps = int(firsts[0]) + 1 if len(firsts) else len(done_after)

    def sort_best(self) -> Tuple[np.ndarray, np.ndarray]:
        order = np.argsort(-self.scores)
        return self.scores[order], order

    def get_best(self):
        scores, ids = self.sort_best()
        return scores[0], ids[0]

    def get_hyp(self, k: int) -> List[int]:
        """Backward walk over the backpointers (reference beam.py:82-95)."""
        hyp = []
        for j in range(self.n_steps - 1, -1, -1):
            hyp.append(int(self.next_Ys[j][k]))
            k = int(self.prev_Ks[j][k])
        return hyp[::-1]


class BeamSearchDecoder:
    """Batch label-sync beam decoder (reference sequence_decoders.py:45-112).

    ``decode(logits)`` takes (B, C, L) as the reference does, or (B, L, C)
    with channels_last=True, arrays or tensors, and returns (probas,
    hypotheses). It runs on ``device``: cuda unless the caller passes
    another (``utils.device.resolve_device``)."""

    def __init__(self, batch_size: int, num_labels: int,
                 mapping_dict: Optional[Dict[str, int]] = None,
                 beam_width: int = 5, cap_seqs: bool = False, *, device=None):
        self.batch_size = batch_size
        self.num_labels = num_labels
        self.symbol_dict = mapping_dict or DEFAULT_BEAM_MAP
        self.beam_width = beam_width
        self.cap_seqs = cap_seqs
        self.device = resolve_device(device)

    @torch.no_grad()
    def decode(self, logits, channels_last: bool = False):
        logits = torch.as_tensor(logits, dtype=torch.float32, device=self.device)
        if not channels_last:
            logits = logits.transpose(1, 2)                 # -> (B, L, C)
        B, T, C = logits.shape
        probs = torch.softmax(logits, dim=-1)
        if self.cap_seqs:
            cap = lambda s: torch.nn.functional.one_hot(
                torch.full((B, 1), self.symbol_dict[s], device=self.device), C).float()
            probs = torch.cat([cap("<s>"), probs, cap("</s>")], dim=1)
        ys = _advance_scan(probs, self.beam_width, self.symbol_dict["</s>"])
        scores_t, prev_ks, next_ys, done_after = (a.cpu().numpy() for a in ys)
        probas, hypotheses = [], []
        for b in range(B):
            beam = Beam(scores_t[b], prev_ks[b], next_ys[b], done_after[b])
            s, ids = beam.sort_best()
            probas.append(float(s[0]))
            hypotheses.append(beam.get_hyp(int(ids[0])))
        return probas, hypotheses
