"""Training losses (wavenet_speech_tpu/training/loss.py): next-signal
cross-entropy on the WaveNet head plus CTC on the classifier head."""
from __future__ import annotations

import dataclasses

import torch

from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_per_seq


def next_signal_xe_loss(signal, signal_pred, signal_lengths=None) -> torch.Tensor:
    """Cross-entropy of the predicted next-level distribution against the
    next quantised level (loss.py:45-68).

    signal (B, L, C) one-hot levels; signal_pred (B, L, C) logits at each t
    for the level at t+1. The target is argmax(signal[:, 1:]); the loss is
    the sum over the first L-1 frames of the batch-mean NLL, divided by L.
    With signal_lengths, frames at or past len-1 count zero."""
    target = torch.argmax(signal[:, 1:, :], dim=-1)
    logp = torch.log_softmax(signal_pred[:, :-1, :].float(), dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    if signal_lengths is not None:
        lens = torch.as_tensor(signal_lengths, device=nll.device)
        frames = torch.arange(nll.shape[1], device=nll.device)[None, :]
        nll = nll * (frames < (lens - 1)[:, None])
    return nll.mean(dim=0).sum() / signal.shape[1]


@dataclasses.dataclass(frozen=True)
class JointLoss:
    """'joint' (XE + CTC) or 'ctc' loss (loss.py:71-111). averaged=True
    divides the batch-summed CTC by T, the reference's per-logit average;
    ctc_weight=0 gives the XE-only pretraining phase."""

    loss_choice: str = "joint"
    averaged: bool = True
    joint_weight: float = 1.0  # weight on the XE term
    ctc_weight: float = 1.0

    def __post_init__(self):
        if self.loss_choice not in ("joint", "ctc"):
            raise ValueError(f"unknown loss_choice {self.loss_choice!r}")

    def calculate(self, signal, signal_pred, transcription_logits, labels,
                  label_lengths, logit_lengths=None, signal_lengths=None):
        """Returns (xe_loss or None, ctc_loss)."""
        B, T = transcription_logits.shape[:2]
        if logit_lengths is None:
            # the reference uses the full logit length for every sequence
            logit_lengths = torch.full((B,), T, dtype=torch.int32,
                                       device=transcription_logits.device)
        ctc = ctc_loss_per_seq(transcription_logits, logit_lengths, labels,
                               label_lengths).sum()
        if self.averaged:
            ctc = ctc / T
        if self.loss_choice == "ctc":
            return None, ctc
        return next_signal_xe_loss(signal, signal_pred, signal_lengths), ctc

    def total(self, *args, **kwargs) -> torch.Tensor:
        """joint_weight * XE + ctc_weight * CTC."""
        xe, ctc = self.calculate(*args, **kwargs)
        if xe is None:
            return ctc
        return self.joint_weight * xe + self.ctc_weight * ctc
