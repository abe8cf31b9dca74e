"""Windowed (banded) softmax attention: query i attends to the keys j with
i - left <= j <= i + right, clipped at the chunk's ends, as Bonito's
transformer basecaller runs it (flash-attn's ``window_size=(left,
right)``; bonito/transformer/model.py ``MultiHeadAttention``).

No TPU kernel of the JAX package computes attention: the kernel was added
for ``models.transformer.TransformerBasecaller``. Its plain versions
would materialise B*H*T^2 scores a layer and keep them for the backward,
three quarters of them masked away at T = 1024 and a band of 256.

On CUDA tensors ``window_attention`` runs the kernels of
``csrc/window_attention.cu`` (W1 forward, W2 backward; built with the
other libraries at the first CUDA call):

  * ``window_attn_fwd_kernel``: one block a (64-query tile, batch, head),
    online softmax over the 32-key tiles that meet the tile's band, keeps
    o and the log-sum-exp;
  * ``window_attn_bwd_dq_kernel``: one block a 64-query tile, recomputes
    the scores from the log-sum-exp, writes delta = rowsum(dO * o) and dq;
  * ``window_attn_bwd_dkv_kernel``: one block a 64-key tile, walks the
    32-query tiles that meet its band, writes dk and dv.

Each output element is written by one block, with no atomics, so two runs
are bit-equal. Every product is a float32-accurate split product (three
TF32 products on the tensor cores, ``csrc/tma_tf32.cuh``). Masked scores
hold -1e30, the online softmax's finite minus infinity. The scores and
probabilities stay in registers: q, k, v, o and dO are read and o, dq,
dk, dv written with no score matrix in device memory. The kernels take
heads of 64 (Bonito's); other widths run on the CPU only.

Off the card the plain version runs: a dense masked softmax over blocks of
queries, each against the keys its band reaches, differentiated by
autograd. ``launches`` counts the kernels launched.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from wavenet_speech_tpu_torch.ops import _build

Window = Tuple[int, int]

HEAD = 64         # the kernels' head width (csrc/window_attention.cu D)
PLAIN_ROWS = 256  # queries a block of the plain version

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, strides (9 int64), ...; B, T, H, left, right, scale, stream
_SIGNATURES = {"wst_window_attn_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
               "wst_window_attn_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _F, _P]}

launches = 0


def band_size(T: int, window: Window) -> int:
    """Query-key pairs in the band of T frames, clipped at the ends."""
    left, right = window
    return sum(min(T - 1, i + right) - max(0, i - left) + 1 for i in range(T))


def _check(q, k, v, window: Window):
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"q, k, v must be (B, T, H, dh) of one shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    left, right = window
    if left < 0 or right < 0:
        raise ValueError(f"window {window}: both sides must be >= 0")


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Window, rows: int = PLAIN_ROWS
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (o (B, T, H, dh), lse (B, H, T)) of q, k, v
    (B, T, H, dh), scaled by 1/sqrt(dh), over blocks of ``rows`` queries,
    each against the keys its band reaches."""
    _check(q, k, v, window)
    B, T, H, dh = q.shape
    left, right = window
    scale = 1.0 / math.sqrt(dh)
    outs, lses = [], []
    for m0 in range(0, T, rows):
        m1 = min(T, m0 + rows)
        n0, n1 = max(0, m0 - left), min(T, m1 + right)
        s = torch.einsum("bihd,bjhd->bhij", q[:, m0:m1], k[:, n0:n1]) * scale
        i = torch.arange(m0, m1, device=q.device)[:, None]
        j = torch.arange(n0, n1, device=q.device)[None, :]
        s = s.masked_fill((j < i - left) | (j > i + right), float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        outs.append(torch.einsum("bhij,bjhd->bihd", p, v[:, n0:n1]))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _operands(*xs):
    for x in xs:
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise ValueError(f"the window attention kernels take float32 CUDA tensors, "
                             f"got {x.dtype} on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError("the window attention kernels need 16-byte aligned tensors")


def _strides(q, k, v):
    """(b, t, h) strides of q, k, v, floats, as the kernels take them."""
    out = []
    for x in (q, k, v):
        if x.stride(-1) != 1 or any(s % 4 for s in x.stride()[:3]):
            raise ValueError("window attention needs a unit stride on the head's dims and "
                             "16-byte aligned rows")
        out += x.stride()[:3]
    return (ctypes.c_longlong * 9)(*out)


def _shape(q):
    B, T, H, dh = q.shape
    if dh != HEAD or B * H >= 65536:
        raise ValueError(f"the window attention kernels take heads of {HEAD} and fewer than "
                         f"65536 (batch, head) pairs, got {tuple(q.shape)}")
    return B, T, H, 1.0 / math.sqrt(dh)


def _call(entry, dev, *args):
    lib = _build.library("window_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, entry)


def window_attention_fwd(q, k, v, window: Window):
    """The forward kernel (W1): (o (B, T, H, dh) contiguous, lse (B, H, T))."""
    global launches
    _check(q, k, v, window)
    _operands(q, k, v)
    B, T, H, scale = _shape(q)
    o = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    lse = torch.empty((B, H, T), device=q.device, dtype=torch.float32)
    _call("wst_window_attn_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          _strides(q, k, v), o.data_ptr(), lse.data_ptr(), B, T, H, window[0], window[1], scale)
    launches += 1
    return o, lse


def window_attention_bwd(q, k, v, o, lse, do, window: Window):
    """The backward kernels (W2): (dq, dk, dv), each (B, T, H, dh)
    contiguous."""
    global launches
    do, o, lse = do.contiguous(), o.contiguous(), lse.contiguous()
    _operands(q, k, v, o, lse, do)
    B, T, H, scale = _shape(q)
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=torch.float32) for _ in range(3))
    delta = torch.empty_like(lse)
    _call("wst_window_attn_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          _strides(q, k, v), o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, window[0], window[1], scale)
    launches += 2
    return dq, dk, dv


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = window_attention_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = window_attention_bwd(q, k, v, o, lse, do, ctx.window)
        return dq, dk, dv, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Window) -> torch.Tensor:
    """Banded softmax attention of q, k, v (B, T, H, dh), the last axis of
    unit stride, scaled by 1/sqrt(dh): o (B, T, H, dh). On CUDA tensors
    the kernels (forward keeps o and the log-sum-exp; backward recomputes
    the scores); elsewhere the plain version, differentiated by autograd."""
    window = (int(window[0]), int(window[1]))
    if q.device.type == "cuda":
        return _WindowAttention.apply(q, k, v, window)
    return window_attention_ref(q, k, v, window)[0]
