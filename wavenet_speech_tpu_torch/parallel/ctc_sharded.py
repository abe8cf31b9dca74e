"""The sequence-sharded CTC loss (wavenet_speech_tpu/parallel/
ctc_sharded.py:60-233): the training-side companion of the halo-exchange
SP forward.

The logits' time axis is sharded over the mesh's "seq" axis. The alpha
recursion is a strict left-to-right recurrence, so it is threaded through
the shards: seq rank i receives the (B, 2S+1) lattice state from rank i-1,
runs its segment with ``t_offset = i * Tl`` (B3's forward), and hands its
last alpha to rank i+1; the last rank's terminal log-likelihoods are
broadcast to every seq rank (JAX's psum-select, an all-reduce of the
masked values). The backward runs the beta chain the other way: the
cotangent is summed over the seq ranks (``psum_cotangent``), then rank i
receives lp + beta from rank i+1, runs B3's backward and hands its own to
rank i-1. Only the lattice state crosses between ranks, never the logits.

Every seq rank runs every step of the chain, forward and backward. So a
rank whose objective does not use the losses must still keep them in its
graph (``JointLoss`` masks them to the last seq rank with a factor of 0),
or the backward chain waits on it forever.

Segments are never padded (JAX pads each to its time chunk and returns
padded alphas, ctc_sharded.py:117-124): every frame of a segment is live
up to a sequence's global length, and a sequence that ends inside an
interior shard carries its alpha through the later shards unchanged.
"""
from __future__ import annotations

import torch

from wavenet_speech_tpu_torch.ops import ctc_scan
from wavenet_speech_tpu_torch.ops.ctc import NEG, _extend_labels, _gather_ext
from wavenet_speech_tpu_torch.parallel.collectives import (all_reduce, p2p,
                                                           psum_cotangent)
from wavenet_speech_tpu_torch.parallel.mesh import Mesh


class _SegmentChain(torch.autograd.Function):
    """Global log-likelihoods (B,) on every seq rank from this rank's
    extended log-probs (Tl, B, J); see the module docstring. Each segment
    is B3: ``ctc_fwd`` / ``ctc_bwd`` with the carry."""

    @staticmethod
    def forward(ctx, lp_ext_t, skipadd, lengths, label_lengths, mesh):
        i, n = mesh.axis_index("seq"), mesh.axis_size("seq")
        Tl, B, J = lp_ext_t.shape
        if i == 0:
            alpha_in = torch.full((B, J), NEG, device=lp_ext_t.device)
        else:
            alpha_in, = p2p(mesh, "seq", [], [(i - 1, (B, J), torch.float32)])
        ll, alphas, alpha_out = ctc_scan.ctc_fwd(lp_ext_t, skipadd, lengths,
                                                 label_lengths, alpha_in, i * Tl)
        if i < n - 1:
            p2p(mesh, "seq", [(i + 1, alpha_out)], [])
        ll = all_reduce(ll if i == n - 1 else torch.zeros_like(ll), mesh, "seq")
        ctx.save_for_backward(lp_ext_t, alphas, skipadd, lengths, label_lengths, ll)
        ctx.mesh = mesh
        return ll

    @staticmethod
    def backward(ctx, cot):
        lp_ext_t, alphas, skipadd, lengths, label_lengths, ll = ctx.saved_tensors
        mesh = ctx.mesh
        i, n = mesh.axis_index("seq"), mesh.axis_size("seq")
        Tl, B, J = lp_ext_t.shape
        if i == n - 1:
            lpb_in = torch.full((B, J), NEG, device=lp_ext_t.device)
        else:
            lpb_in, = p2p(mesh, "seq", [], [(i + 1, (B, J), torch.float32)])
        grad, lpb_out = ctc_scan.ctc_bwd(lp_ext_t, alphas, skipadd, lengths,
                                         label_lengths, ll, cot.contiguous(), lpb_in,
                                         i * Tl)
        if i > 0:
            p2p(mesh, "seq", [(i - 1, lpb_out)], [])
        return grad, None, None, None, None


def ctc_loss_seq_sharded(mesh: Mesh, logits_local, logit_lengths, labels, label_lengths,
                         blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihoods over time-sharded logits.

    logits_local (B, Tl, C): this rank's frames of unnormalised logits
    (softmax inside, warp-ctc's convention, as ``ops.ctc.
    ctc_loss_per_seq``); frame lt is global frame seq_index * Tl + lt.
    logit_lengths (global frame counts), labels (B, S), label_lengths: per
    sequence, for logits_local's rows. On CUDA tensors the segments launch
    B3's kernels, on CPU tensors they run their plain versions.

    Returns the (B,) losses on every seq rank, differentiable in
    logits_local. The backward sums the cotangents of all seq ranks' copies,
    so a global objective takes the losses from one seq rank."""
    dev = logits_local.device
    labels = torch.as_tensor(labels, device=dev)
    if labels.shape[0] != logits_local.shape[0]:
        raise ValueError(f"ctc_loss_seq_sharded: {labels.shape[0]} label rows for "
                         f"{logits_local.shape[0]} logit rows")
    lp = torch.log_softmax(logits_local.float(), dim=-1)
    ext, allow_skip = _extend_labels(labels, blank)
    lp_ext_t = _gather_ext(lp, ext).transpose(0, 1).contiguous()   # (Tl, B, 2S+1)
    skipadd = torch.where(allow_skip, 0.0, NEG)
    ll = _SegmentChain.apply(lp_ext_t, skipadd, ctc_scan._i32(logit_lengths, dev),
                             ctc_scan._i32(label_lengths, dev), mesh)
    return -psum_cotangent(ll, mesh, "seq")
