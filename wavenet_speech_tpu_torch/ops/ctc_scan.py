"""The CTC alpha/beta recursion over extended-label log-probs: the CUDA
counterpart of wavenet_speech_tpu/ops/pallas/ctc.py (``_fwd_kernel``, B1,
launched by ``_ctc_fwd_impl``; ``_bwd_kernel``, B2, launched by
``_ctc_bwd_impl``).

``ctc_scan`` is a ``torch.autograd.Function`` at the JAX custom-VJP
boundary (pallas/ctc.py:206-214, 313-328): the input is the already
gathered (T, B, 2S+1) log-probs, so the gather and the log-softmax stay
ordinary autograd ops. Its forward runs ``ctc_fwd`` (B1) and saves every
alpha; its backward runs ``ctc_bwd`` (B2), which writes the posterior
occupancy exp(alpha + beta - ll) * cotangent.

``ctc_fwd`` and ``ctc_bwd`` launch ``csrc/ctc.cu`` on CUDA tensors and run
``ctc_fwd_ref`` and ``ctc_bwd_ref``, the plain frame loops, on CPU
tensors. Both take the segment carry of the TPU kernels (``alpha_in`` /
``lpb_in``, ``t_offset``, ``tl_true``), which the sequence-sharded CTC
will use. The TPU's time chunking (``_pick_ct``, ``_pad_T``) existed only
for its VMEM and is not ported: T is never padded.

What bounds them on an H100: at the bench shape (T=1126, B=8, J=859) B1
moves 62 MB and B2 93 MB (0.02-0.03 ms at 3.35 TB/s), but each runs T
dependent frames, one block barrier a frame, on B blocks (B SMs). See the
source note in ``csrc/ctc.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from wavenet_speech_tpu_torch.ops import _build
from wavenet_speech_tpu_torch.ops.ctc import (NEG, _extend_labels, _gather_ext,
                                              logaddexp)

_P, _I = ctypes.c_void_p, ctypes.c_int
# B1: lp, skipadd, lengths, label_lengths, alpha_in, alphas, ll, alpha_out;
#     T, B, J, t_offset, tl_true; stream
# B2: lp, alphas, skipadd, lengths, label_lengths, ll, cot, lpb_in, grad,
#     lpb_out; T, B, J, t_offset, tl_true; stream
_SIGNATURES = {"wst_ctc_alpha_f32": [_P] * 8 + [_I] * 5 + [_P],
               "wst_ctc_beta_f32": [_P] * 10 + [_I] * 5 + [_P]}
MAX_STATES = 8192  # J = 2S+1 the kernels take: 8 states a thread, 1024 threads


def _shift_right(x, n):
    """x[:, j] <- x[:, j-n], NEG in the first n lanes."""
    return torch.cat([torch.full_like(x[:, :n], NEG), x[:, :-n]], dim=1)


def _shift_left(x, n):
    """x[:, j] <- x[:, j+n], NEG in the last n lanes."""
    return torch.cat([x[:, n:], torch.full_like(x[:, :n], NEG)], dim=1)


def _terminal_mask(label_lengths, J: int, device):
    """(B, J) additive mask: 0 at the final blank (2L) and final label
    (2L-1) states, NEG elsewhere (pallas/ctc.py:75-80)."""
    iota = torch.arange(J, device=device)[None, :]
    lab = label_lengths.long()[:, None]
    ok = (iota == 2 * lab) | ((iota == 2 * lab - 1) & (lab > 0))
    return torch.where(ok, 0.0, NEG)


def ctc_fwd_ref(lp_ext_t, skipadd, logit_lengths, label_lengths,
                alpha_in: Optional[torch.Tensor] = None, t_offset: int = 0,
                tl_true: Optional[int] = None):
    """The plain version of B1 (pallas/ctc.py:83-139) as a frame loop.

    lp_ext_t (T, B, J) f32; skipadd (B, J) additive skip mask (0 / NEG);
    lengths (B,). Frame lt is global frame t_offset + lt; frames at or past
    tl_true or a sequence's length carry alpha through. Returns
    (ll (B,), alphas (T, B, J), alpha_out (B, J))."""
    T, B, J = lp_ext_t.shape
    tl_true = T if tl_true is None else tl_true
    dev = lp_ext_t.device
    alpha = (torch.full((B, J), NEG, device=dev) if alpha_in is None
             else alpha_in.float())
    iota = torch.arange(J, device=dev)[None, :]
    lab = label_lengths.long()[:, None]
    lens = logit_lengths.long()[:, None]
    init_mask = (iota == 0) | ((iota == 1) & (lab > 0))
    alphas = torch.empty((T, B, J), device=dev)
    for lt in range(T):
        t = t_offset + lt
        lp_t = lp_ext_t[lt]
        acc = logaddexp(alpha, _shift_right(alpha, 1))
        acc = logaddexp(acc, _shift_right(alpha, 2) + skipadd)
        new = torch.where(init_mask, lp_t, NEG) if t == 0 else acc + lp_t
        if lt < tl_true:
            alpha = torch.where(t < lens, new, alpha)
        alphas[lt] = alpha
    masked = alpha + _terminal_mask(label_lengths, J, dev)
    m = masked.max(dim=1, keepdim=True).values
    ll = m + torch.log(torch.exp(masked - m).sum(dim=1, keepdim=True))
    return ll[:, 0], alphas, alpha


def ctc_bwd_ref(lp_ext_t, alphas, skipadd, logit_lengths, label_lengths, ll,
                cot, lpb_in: Optional[torch.Tensor] = None, t_offset: int = 0,
                tl_true: Optional[int] = None):
    """The plain version of B2 (pallas/ctc.py:142-189): the beta recursion
    backward in time, carrying lp + beta. Returns (grad (T, B, J) =
    exp(alpha + beta - ll) * cot, 0 on frames at or past tl_true;
    lpb_out (B, J))."""
    T, B, J = lp_ext_t.shape
    tl_true = T if tl_true is None else tl_true
    dev = lp_ext_t.device
    lpb = (torch.full((B, J), NEG, device=dev) if lpb_in is None
           else lpb_in.float())
    term = _terminal_mask(label_lengths, J, dev)
    sk2 = _shift_left(skipadd, 2)   # j -> j+2 allowed iff the skip into j+2 is
    lens = logit_lengths.long()[:, None]
    ll, cot = ll[:, None], cot.float()[:, None]
    grad = torch.zeros((T, B, J), device=dev)
    for lt in reversed(range(min(T, tl_true))):
        t = t_offset + lt
        rec = logaddexp(logaddexp(lpb, _shift_left(lpb, 1)), _shift_left(lpb, 2) + sk2)
        beta = torch.where(t == lens - 1, term, torch.where(t < lens, rec, NEG))
        grad[lt] = torch.exp(alphas[lt] + beta - ll) * cot
        lpb = lp_ext_t[lt] + beta
    return grad, lpb


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def _check(name, lp, *tensors):
    if lp.dim() != 3:
        raise ValueError(f"{name}: lp_ext_t must be (T, B, J), got {tuple(lp.shape)}")
    T, B, J = lp.shape
    if J > MAX_STATES:
        raise ValueError(f"{name}: the kernel takes at most {MAX_STATES} lattice "
                         f"states (2S+1), got {J}")
    for t in (lp, *tensors):
        if t.device != lp.device:
            raise ValueError(f"{name}: tensors on {t.device} and {lp.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: every float input must be contiguous float32")
    return T, B, J


def ctc_fwd(lp_ext_t, skipadd, logit_lengths, label_lengths,
            alpha_in: Optional[torch.Tensor] = None, t_offset: int = 0,
            tl_true: Optional[int] = None):
    """B1: (ll, alphas, alpha_out); see ``ctc_fwd_ref``. On a CPU tensor
    this is ``ctc_fwd_ref``; on a CUDA tensor it launches the kernel or
    raises. ``ctc_fwd.launches`` counts kernel launches."""
    if lp_ext_t.device.type == "cpu":
        return ctc_fwd_ref(lp_ext_t, skipadd, logit_lengths, label_lengths,
                           alpha_in, t_offset, tl_true)
    if lp_ext_t.device.type != "cuda":
        raise ValueError(f"ctc_fwd: unsupported device {lp_ext_t.device}")
    dev = lp_ext_t.device
    T, B, J = lp_ext_t.shape
    if alpha_in is None:
        alpha_in = torch.full((B, J), NEG, device=dev)
    _check("ctc_fwd", lp_ext_t, skipadd, alpha_in)
    lens, lab = _i32(logit_lengths, dev), _i32(label_lengths, dev)
    alphas = torch.empty((T, B, J), device=dev)
    ll = torch.empty((B,), device=dev)
    alpha_out = torch.empty((B, J), device=dev)
    lib = _build.library("ctc", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.wst_ctc_alpha_f32(
            lp_ext_t.data_ptr(), skipadd.data_ptr(), lens.data_ptr(), lab.data_ptr(),
            alpha_in.data_ptr(), alphas.data_ptr(), ll.data_ptr(), alpha_out.data_ptr(),
            T, B, J, int(t_offset), T if tl_true is None else int(tl_true),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "ctc_fwd")
    ctc_fwd.launches += 1
    return ll, alphas, alpha_out


def ctc_bwd(lp_ext_t, alphas, skipadd, logit_lengths, label_lengths, ll, cot,
            lpb_in: Optional[torch.Tensor] = None, t_offset: int = 0,
            tl_true: Optional[int] = None):
    """B2: (grad, lpb_out); see ``ctc_bwd_ref``. On a CPU tensor this is
    ``ctc_bwd_ref``; on a CUDA tensor it launches the kernel or raises.
    ``ctc_bwd.launches`` counts kernel launches."""
    if lp_ext_t.device.type == "cpu":
        return ctc_bwd_ref(lp_ext_t, alphas, skipadd, logit_lengths, label_lengths,
                           ll, cot, lpb_in, t_offset, tl_true)
    if lp_ext_t.device.type != "cuda":
        raise ValueError(f"ctc_bwd: unsupported device {lp_ext_t.device}")
    dev = lp_ext_t.device
    T, B, J = lp_ext_t.shape
    if lpb_in is None:
        lpb_in = torch.full((B, J), NEG, device=dev)
    cot = cot.float().contiguous()
    _check("ctc_bwd", lp_ext_t, alphas, skipadd, ll, cot, lpb_in)
    if alphas.shape != lp_ext_t.shape or ll.shape != (B,) or cot.shape != (B,):
        raise ValueError("ctc_bwd: alphas must be (T, B, J), ll and cot (B,)")
    lens, lab = _i32(logit_lengths, dev), _i32(label_lengths, dev)
    grad = torch.empty((T, B, J), device=dev)
    lpb_out = torch.empty((B, J), device=dev)
    lib = _build.library("ctc", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.wst_ctc_beta_f32(
            lp_ext_t.data_ptr(), alphas.data_ptr(), skipadd.data_ptr(), lens.data_ptr(),
            lab.data_ptr(), ll.data_ptr(), cot.data_ptr(), lpb_in.data_ptr(),
            grad.data_ptr(), lpb_out.data_ptr(),
            T, B, J, int(t_offset), T if tl_true is None else int(tl_true),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "ctc_bwd")
    ctc_bwd.launches += 1
    return grad, lpb_out


ctc_fwd.launches = 0
ctc_bwd.launches = 0


class _CTCScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_ext_t, skipadd, logit_lengths, label_lengths):
        ll, alphas, _ = ctc_fwd(lp_ext_t, skipadd, logit_lengths, label_lengths)
        ctx.save_for_backward(lp_ext_t, alphas, skipadd, logit_lengths,
                              label_lengths, ll)
        return ll

    @staticmethod
    def backward(ctx, cot):
        lp_ext_t, alphas, skipadd, logit_lengths, label_lengths, ll = ctx.saved_tensors
        grad, _ = ctc_bwd(lp_ext_t, alphas, skipadd, logit_lengths, label_lengths,
                          ll, cot)
        return grad, None, None, None


def ctc_scan(lp_ext_t, skipadd, logit_lengths, label_lengths) -> torch.Tensor:
    """Log-likelihoods (B,) from extended-label log-probs (T, B, 2S+1),
    differentiable in lp_ext_t (the exact posterior-occupancy gradient).
    skipadd (B, 2S+1): 0 where the skip into a state is allowed, NEG else."""
    dev = lp_ext_t.device
    return _CTCScan.apply(lp_ext_t.float().contiguous(), skipadd.float().contiguous(),
                          _i32(logit_lengths, dev), _i32(label_lengths, dev))


def ctc_forward_logprob_kernel(log_probs, logit_lengths, labels, label_lengths,
                               blank: int = 0) -> torch.Tensor:
    """Drop-in for ``ops.ctc.ctc_forward_logprob`` that runs the recursion
    through ``ctc_scan`` (pallas/ctc.py:373-386)."""
    log_probs = log_probs.float()
    ext, allow_skip = _extend_labels(torch.as_tensor(labels, device=log_probs.device),
                                     blank)
    lp_ext_t = _gather_ext(log_probs, ext).transpose(0, 1)
    skipadd = torch.where(allow_skip, 0.0, NEG)
    return ctc_scan(lp_ext_t, skipadd, logit_lengths, label_lengths)
