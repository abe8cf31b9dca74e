"""Training losses (wavenet_speech_tpu/training/loss.py): next-signal
cross-entropy on the WaveNet head plus CTC on the classifier head.

On a mesh (``JointLoss.calculate(..., mesh=mesh)``) each rank holds its
(data, seq) shard of the batch and computes its share of each term, so
that the shares of all ranks add up to the single-device loss:

  * XE, a batch mean summed over frames and divided by L: this rank's NLL
    sum over its frames, divided by the global B and L. A shard's last
    frame's target is the next shard's first frame (a one-frame right halo
    of the signal); the global last frame has none; the length mask keys
    on global frame indices.
  * CTC, a batch sum divided by the global T: the sequence-sharded CTC
    (``parallel.ctc_sharded``) returns each sequence's loss on every seq
    rank; the last seq rank's count, the others' are multiplied by 0, which
    keeps them in every rank's graph (the CTC's backward is a chain through
    every seq rank).

The returned terms are the global values on every rank, and their gradient
is this rank's share: summing the gradients over all ranks (the train
step's all-reduce) gives the single-device gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_per_seq
from wavenet_speech_tpu_torch.parallel.collectives import STAT_AXES, all_reduce
from wavenet_speech_tpu_torch.parallel.ctc_sharded import ctc_loss_seq_sharded
from wavenet_speech_tpu_torch.parallel.halo import halo_pad
from wavenet_speech_tpu_torch.parallel.mesh import Mesh


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


def _xe_share(signal, signal_pred, signal_lengths, mesh: Mesh) -> torch.Tensor:
    """This rank's share of ``next_signal_xe_loss`` over the global batch."""
    B, Ll, _ = signal.shape
    n_seq, i = mesh.axis_size("seq"), mesh.axis_index("seq")
    B_g, L_g = B * mesh.axis_size("data"), Ll * n_seq
    # the target at local frame lt is the level at global frame t + 1
    nxt = halo_pad(signal[:, :1].float(), 0, 1, mesh)[:, 1:]
    target = torch.argmax(torch.cat([signal[:, 1:].float(), nxt], dim=1), dim=-1)
    logp = torch.log_softmax(signal_pred.float(), dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    t = i * Ll + torch.arange(Ll, device=nll.device)[None, :]
    live = t < L_g - 1
    if signal_lengths is not None:
        lens = torch.as_tensor(signal_lengths, device=nll.device)
        live = live & (t < (lens - 1)[:, None])
    return (nll * live).sum() / (B_g * L_g)


def _global(share: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the shares over the data and seq lines (the ranks of a
    "model" line hold the same share), whose gradient is this rank's
    share's."""
    total = all_reduce(share, mesh, STAT_AXES)
    return share + (total - share.detach())


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
                  label_lengths, logit_lengths=None, signal_lengths=None,
                  mesh: Optional[Mesh] = None):
        """Returns (xe_loss or None, ctc_loss). With a mesh the inputs are
        this rank's shard (time-sharded over "seq"; lengths global) and the
        terms global (see the module docstring)."""
        B, T = transcription_logits.shape[:2]
        n_seq = 1 if mesh is None else mesh.axis_size("seq")
        T_g = T * n_seq
        if logit_lengths is None:
            # the reference uses the full logit length for every sequence
            logit_lengths = torch.full((B,), T_g, dtype=torch.int32,
                                       device=transcription_logits.device)
        if n_seq > 1:
            per_seq = ctc_loss_seq_sharded(mesh, transcription_logits, logit_lengths,
                                           labels, label_lengths)
            last = mesh.axis_index("seq") == n_seq - 1
            ctc = per_seq.sum() * (1.0 if last else 0.0)
        else:
            ctc = ctc_loss_per_seq(transcription_logits, logit_lengths, labels,
                                   label_lengths).sum()
        if self.averaged:
            ctc = ctc / T_g
        if mesh is not None:
            ctc = _global(ctc, mesh)
        if self.loss_choice == "ctc":
            return None, ctc
        if mesh is None:
            return next_signal_xe_loss(signal, signal_pred, signal_lengths), ctc
        return _global(_xe_share(signal, signal_pred, signal_lengths, mesh), mesh), ctc

    def total(self, *args, **kwargs) -> torch.Tensor:
        """joint_weight * XE + ctc_weight * CTC."""
        xe, ctc = self.calculate(*args, **kwargs)
        if xe is None:
            return ctc
        return self.joint_weight * xe + self.ctc_weight * ctc
