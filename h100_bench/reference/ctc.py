"""The CTC negative log-likelihood, written out as the alpha recursion in
float64 (blank 0, log-softmax taken inside, warp-ctc's convention), and
differentiated by autograd."""
from __future__ import annotations

import torch

NEG = -1e300  # finite, so logsumexp's gradient stays finite


def ctc_nll(logits, logit_lengths, labels, label_lengths, blank: int = 0):
    """Per-sequence -log p(labels | logits): logits (B, T, C), labels
    (B, S) padded, lengths (B,). Returns (B,) float64."""
    lp = torch.log_softmax(logits.double(), dim=-1)
    B, T, _ = lp.shape
    S = labels.shape[1]
    J = 2 * S + 1
    dev = lp.device
    ext = torch.full((B, J), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    lpe = lp.gather(2, ext[:, None, :].expand(B, T, J))
    pos = torch.arange(J, device=dev)[None, :]
    prev2 = torch.cat([torch.full((B, 2), blank, dtype=torch.long, device=dev), ext[:, :-2]], 1)
    skip = (pos >= 2) & (ext != blank) & (ext != prev2)
    neg = torch.full((B, 1), NEG, dtype=lp.dtype, device=dev)
    label_lengths = label_lengths.to(dev).long()
    logit_lengths = logit_lengths.to(dev).long()
    alpha = torch.cat([lpe[:, 0, :1],
                       torch.where(label_lengths[:, None] > 0, lpe[:, 0, 1:2], neg),
                       neg.expand(B, J - 2)], dim=1)
    for t in range(1, T):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg, neg, alpha[:, :-2]], dim=1), NEG)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) + lpe[:, t]
        alpha = torch.where((t < logit_lengths)[:, None], new, alpha)
    end = 2 * label_lengths
    last = alpha.gather(1, end[:, None])[:, 0]
    before = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    before = torch.where(label_lengths > 0, before, torch.full_like(before, NEG))
    return -torch.logaddexp(last, before)
