"""CTC loss (wavenet_speech_tpu/ops/ctc.py), warp-ctc's calling convention:

  * inputs are unnormalised activations; the log-softmax is taken inside,
  * the blank label is 0,
  * ``ctc_loss`` is the sum over the batch of per-sequence negative
    log-likelihoods (``ctc_loss_per_seq`` gives them one by one),
  * -1e30 stands in for -inf, which keeps every logaddexp gradient finite.

``ctc_loss_per_seq`` runs the recursion through ``ops.ctc_scan.ctc_scan``:
the alpha and beta kernels (B1, B2) on the card, their plain frame loops on
the CPU. ``ctc_forward_logprob`` is the plain recursion of the JAX XLA path
(ops/ctc.py:55-128), differentiated by autograd; it is the reference that
the tests hold the kernel path to.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG = -1e30  # the JAX package's stand-in for -inf


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``'s exact form (jax/_src/lax/other.py:262-273):
    max(a, b) + log1p(exp(-|a - b|)), and a + b where a - b is NaN."""
    d = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(d)))
    return torch.where(torch.isnan(d), a + b, out)


def _extend_labels(labels: torch.Tensor, blank: int):
    """(B, S) labels -> (B, 2S+1) blank-interleaved extended labels and the
    skip mask of the CTC lattice (ops/ctc.py:35-45): the transition j-2 -> j
    is allowed iff ext[j] is no blank and differs from ext[j-2]."""
    B, S = labels.shape
    ext = torch.full((B, 2 * S + 1), blank, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    prev2 = torch.cat([torch.full((B, 2), blank, dtype=ext.dtype, device=ext.device),
                       ext[:, :-2]], dim=1)
    pos = torch.arange(2 * S + 1, device=labels.device)[None, :]
    allow_skip = (pos >= 2) & (ext != blank) & (ext != prev2)
    return ext, allow_skip


def _gather_ext(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """(B, T, C) log-probs at the extended-label positions -> (B, T, 2S+1),
    as the one-hot contraction of ops/ctc.py:48-52. Its backward is a
    matmul too, so the gradient does not depend on the order of atomics."""
    onehot = torch.nn.functional.one_hot(ext.long(), log_probs.shape[-1]).to(log_probs.dtype)
    return torch.einsum("btc,bjc->btj", log_probs, onehot)


def ctc_alpha_init(lp_ext_0: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """Alpha at frame 0 (ops/ctc.py:85-94)."""
    alpha0 = torch.full_like(lp_ext_0, NEG)
    alpha0[:, 0] = lp_ext_0[:, 0]
    if lp_ext_0.shape[1] > 1:
        alpha0[:, 1] = torch.where(label_lengths > 0, lp_ext_0[:, 1], NEG)
    return alpha0


def ctc_alpha_scan(alpha, lp_ext_t, ts, logit_lengths, skip_mask):
    """Advance alpha over the frames lp_ext_t (T', B, 2S+1) whose global
    indices are ts (T',); frames at or past a sequence's length carry alpha
    through unchanged (ops/ctc.py:97-117)."""
    B = alpha.shape[0]
    neg = torch.full((B, 2), NEG, dtype=alpha.dtype, device=alpha.device)
    for lp_t, t in zip(lp_ext_t, ts):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, alpha[:, :-2]], dim=1)
        acc = logaddexp(alpha, a1)
        acc = torch.where(skip_mask, logaddexp(acc, a2), acc)
        live = (t < logit_lengths)[:, None]
        alpha = torch.where(live, acc + lp_t, alpha)
    return alpha


def ctc_alpha_terminal(alpha, label_lengths):
    """Log-likelihood from the final alpha: logaddexp of the final blank
    (2L) and final label (2L-1) states (ops/ctc.py:120-128)."""
    idx_last = (2 * label_lengths).long()[:, None]
    a_last = torch.gather(alpha, 1, idx_last)[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(idx_last - 1, min=0))[:, 0]
    return torch.where(label_lengths > 0, logaddexp(a_last, a_prev), a_last)


def ctc_forward_logprob(log_probs, logit_lengths, labels, label_lengths,
                        blank: int = 0) -> torch.Tensor:
    """Log-likelihood log P(labels | log_probs) per sequence, as the plain
    recursion (differentiable by autograd).

    log_probs (B, T, C); logit_lengths (B,) valid frames; labels (B, S)
    dense, padding past label_lengths ignored; label_lengths (B,).
    Returns (B,)."""
    log_probs = log_probs.float()
    T = log_probs.shape[1]
    ext, allow_skip = _extend_labels(labels, blank)
    lp_ext_t = _gather_ext(log_probs, ext).transpose(0, 1)  # (T, B, 2S+1)
    alpha = ctc_alpha_init(lp_ext_t[0], label_lengths)
    alpha = ctc_alpha_scan(alpha, lp_ext_t[1:], range(1, T), logit_lengths, allow_skip)
    return ctc_alpha_terminal(alpha, label_lengths)


def ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths,
                     blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood (B,) of unnormalised
    logits (B, T, C), through the B1/B2 kernels on the card."""
    from wavenet_speech_tpu_torch.ops.ctc_scan import ctc_forward_logprob_kernel

    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return -ctc_forward_logprob_kernel(log_probs, logit_lengths, labels,
                                       label_lengths, blank)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank: int = 0) -> torch.Tensor:
    """Summed-over-batch CTC loss (warp-ctc's default reduction)."""
    return ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths, blank).sum()


def densify_labels(flat_labels, label_lengths, max_len: Optional[int] = None,
                   pad: int = 0) -> np.ndarray:
    """warp-ctc's concatenated labels -> a dense (B, S) int32 array, on the
    host (ops/ctc.py:170-185)."""
    flat_labels = np.asarray(flat_labels)
    label_lengths = np.asarray(label_lengths)
    B = label_lengths.shape[0]
    S = int(max_len) if max_len is not None else (int(label_lengths.max()) if B else 0)
    dense = np.full((B, S), pad, dtype=np.int32)
    off = 0
    for b, n in enumerate(label_lengths):
        n = int(n)
        dense[b, :n] = flat_labels[off:off + n]
        off += n
    return dense
