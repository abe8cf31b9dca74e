"""Fused causal gated residual block: the CUDA counterpart of
wavenet_speech_tpu/ops/pallas/residual_block.py (``_kernel``, B4, launched
by ``_forward``; ``_bwd_kernel``, B5, launched by ``_pallas_bwd``).

    gate  = sum_k x_shift(k) @ gate_w[k] + gate_b       (K dilated taps)
    act   = tanh(gate[:, :C]) * sigmoid(gate[:, C:])
    o     = act @ out_w + out_b                          (residual|skip 1x1)
    resid = o[:, :C] + x @ res_w + res_b
    skip  = o[:, C:]

``fused_gated_block`` runs ``fused_gated_block_ref``, the plain version, on
a CPU tensor (autograd differentiates it there). On a CUDA tensor it is a
``torch.autograd.Function`` whose forward launches ``csrc/fused_block.cu``
(B4) and saves only x and the weights, as the TPU kernel does, and whose
backward launches ``csrc/fused_block_bwd.cu`` (B5), which recomputes the
gate. ``fused_gated_block_bwd`` is that backward; its plain version is
``fused_gated_block_bwd_ref``.

Where the time goes on an H100, at the bench shape (B=8, L=4505,
C_in=C=256, K=2): the forward is 33 GFLOP against ~115 MB moved and the
backward 85 GFLOP against ~150 MB, so both are bound by operations (f32,
CUDA cores). The forward keeps ``act`` and the (L, 2C) gate out of device
memory, reads each tap's rows of x separately (the TPU kernel's one
contiguous halo window is >500 KB at d=512, over a block's 227 KB of shared
memory), and streams the weights from L2 in 16-deep chunks. The backward
writes dg and act once and reduces the weight gradients over fixed frame
slices. See the source notes in ``csrc/``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wavenet_speech_tpu_torch.ops import _build
from wavenet_speech_tpu_torch.ops.activations import gated_activation

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, gate_w, gate_b, out_w, out_b, res_w, res_b, resid, skip;
# B, L, C_in, C, K, dilation; stream
_SIGNATURES = {"wst_fused_gated_block_f32": [_P] * 9 + [_I] * 6 + [_P]}
# x, dresid, dskip, gate_w, gate_b, out_w^T, gate_w^T, res_w^T, dx, grads,
# dg, act, part; B, L, C_in, C, K, dilation; stream
_BWD_SIGNATURES = {"wst_fused_gated_block_bwd_f32": [_P] * 13 + [_I] * 6 + [_P],
                   "wst_fused_block_bwd_slices": []}
MAX_TAPS = 8  # gate kernel widths the backward kernel takes


def fused_gated_block_ref(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                          dilation: int):
    """The plain version: the math of ``_xla_reference``
    (residual_block.py:44-55), with the causal conv written as K shifted
    matmuls, as the kernel computes it.

    x: (B, L, C_in); gate_w: (K, C_in, 2C); gate_b: (2C,); out_w: (C, 2C);
    out_b: (2C,); res_w: (C_in, C); res_b: (C,). Returns (resid, skip),
    each (B, L, C)."""
    K = gate_w.shape[0]
    L = x.shape[1]
    C = res_w.shape[1]
    xp = F.pad(x, (0, 0, (K - 1) * dilation, 0))
    g = gate_b + sum(xp[:, j * dilation: j * dilation + L] @ gate_w[j]
                     for j in range(K))
    act = gated_activation(g[..., :C], g[..., C:])
    o = act @ out_w + out_b
    resid = o[..., :C] + x @ res_w + res_b
    return resid, o[..., C:]


def _check_args(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation,
                **cotangents):
    """Raise unless the kernels take these tensors. The backward passes
    out_b = res_b = None (it needs neither) and the cotangents (dresid,
    dskip), each (B, L, C)."""
    args = dict(x=x, gate_w=gate_w, gate_b=gate_b, out_w=out_w, out_b=out_b,
                res_w=res_w, res_b=res_b, **cotangents)
    args = {name: t for name, t in args.items() if t is not None}
    for name, t in args.items():
        if t.device != x.device:
            raise ValueError(f"fused_gated_block: {name} is on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_gated_block: {name} must be float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_gated_block: {name} must be contiguous "
                             f"and 16-byte aligned")
    if x.dim() != 3 or gate_w.dim() != 3:
        raise ValueError("fused_gated_block: x must be (B, L, C_in) and "
                         "gate_w (K, C_in, 2C)")
    B, L, C_in = x.shape
    K = gate_w.shape[0]
    C = res_w.shape[-1]
    expect = dict(gate_w=(K, C_in, 2 * C), gate_b=(2 * C,), out_w=(C, 2 * C),
                  out_b=(2 * C,), res_w=(C_in, C), res_b=(C,),
                  **{name: (B, L, C) for name in cotangents})
    for name, shape in expect.items():
        if name in args and tuple(args[name].shape) != shape:
            raise ValueError(f"fused_gated_block: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if C_in % 4 or C % 4:
        raise ValueError("fused_gated_block: the CUDA kernel needs C_in and C "
                         f"divisible by 4, got C_in={C_in}, C={C}")
    if dilation < 1:
        raise ValueError(f"fused_gated_block: dilation must be >= 1, got {dilation}")
    if cotangents and K > MAX_TAPS:
        raise ValueError(f"fused_gated_block: the backward kernel takes at most "
                         f"{MAX_TAPS} taps, got {K}")
    return B, L, C_in, C, K


def _launch_fwd(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation: int):
    B, L, C_in, C, K = _check_args(x, gate_w, gate_b, out_w, out_b, res_w,
                                   res_b, dilation)
    resid = torch.empty((B, L, C), device=x.device, dtype=x.dtype)
    skip = torch.empty_like(resid)
    lib = _build.library("fused_block", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.wst_fused_gated_block_f32(
            x.data_ptr(), gate_w.data_ptr(), gate_b.data_ptr(),
            out_w.data_ptr(), out_b.data_ptr(), res_w.data_ptr(),
            res_b.data_ptr(), resid.data_ptr(), skip.data_ptr(),
            B, L, C_in, C, K, dilation,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fused_gated_block")
    fused_gated_block.launches += 1
    return resid, skip


class _FusedGatedBlock(torch.autograd.Function):
    """B4 forward, B5 backward. Saves x and the weights only: the backward
    recomputes the gate, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation):
        resid, skip = _launch_fwd(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                                  dilation)
        ctx.save_for_backward(x, gate_w, gate_b, out_w, res_w)
        ctx.dilation = dilation
        return resid, skip

    @staticmethod
    def backward(ctx, dresid, dskip):
        x, gate_w, gate_b, out_w, res_w = ctx.saved_tensors
        dx, dwg, dbg, dwo, dbo, dwr, dbr = fused_gated_block_bwd(
            x, gate_w, gate_b, out_w, res_w, dresid.contiguous(),
            dskip.contiguous(), ctx.dilation)
        return dx, dwg, dbg, dwo, dbo, dwr, dbr, None


def fused_gated_block(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                      dilation: int):
    """Fused causal gated residual block; see the module docstring.

    On a CPU tensor this is ``fused_gated_block_ref``. On a CUDA tensor it
    launches the kernels (float32, contiguous) or raises; it never falls
    back. ``fused_gated_block.launches`` counts forward launches."""
    if x.device.type == "cpu":
        return fused_gated_block_ref(x, gate_w, gate_b, out_w, out_b, res_w,
                                     res_b, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gated_block: unsupported device {x.device}")
    return _FusedGatedBlock.apply(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                                  dilation)


fused_gated_block.launches = 0


def fused_gated_block_bwd_ref(x, gate_w, gate_b, out_w, res_w, dresid, dskip,
                              dilation: int):
    """The plain version of B5: the math of ``_bwd_kernel``
    (residual_block.py:201-300) with the gate recomputed over the whole
    sequence. Returns (dx, d gate_w, d gate_b, d out_w, d out_b, d res_w,
    d res_b), shaped as the forward's arguments."""
    K, C_in, C2 = gate_w.shape
    B, L, _ = x.shape
    C = res_w.shape[1]
    h = (K - 1) * dilation
    xp = F.pad(x, (0, 0, h, 0))
    taps = [xp[:, j * dilation: j * dilation + L] for j in range(K)]
    g = gate_b + sum(taps[j] @ gate_w[j] for j in range(K))
    th, sg = torch.tanh(g[..., :C]), torch.sigmoid(g[..., C:])
    act = th * sg
    do = torch.cat([dresid, dskip], dim=-1)
    da = do @ out_w.T
    dg = torch.cat([da * sg * (1.0 - th * th), da * th * sg * (1.0 - sg)], dim=-1)
    dgp = F.pad(dg, (0, 0, 0, h))  # dx pulls dg from future frames
    dx = dresid @ res_w.T
    for j in range(K):
        s = (K - 1 - j) * dilation
        dx = dx + dgp[:, s: s + L] @ gate_w[j].T
    rows = lambda t: t.reshape(B * L, t.shape[-1])
    dwg = torch.stack([rows(taps[j]).T @ rows(dg) for j in range(K)])
    return (dx, dwg, dg.sum(dim=(0, 1)), rows(act).T @ rows(do),
            do.sum(dim=(0, 1)), rows(x).T @ rows(dresid), dresid.sum(dim=(0, 1)))


def fused_gated_block_bwd(x, gate_w, gate_b, out_w, res_w, dresid, dskip,
                          dilation: int):
    """B5: the gradients of ``fused_gated_block`` (see
    ``fused_gated_block_bwd_ref``). On a CPU tensor this is the plain
    version; on a CUDA tensor it launches the kernel or raises.
    ``fused_gated_block_bwd.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_gated_block_bwd_ref(x, gate_w, gate_b, out_w, res_w, dresid,
                                         dskip, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gated_block_bwd: unsupported device {x.device}")
    B, L, C_in, C, K = _check_args(x, gate_w, gate_b, out_w, None, res_w, None,
                                   dilation, dresid=dresid, dskip=dskip)
    lib = _build.library("fused_block_bwd", _BWD_SIGNATURES)
    dev = x.device
    empty = lambda *s: torch.empty(s, device=dev)
    sizes = (K * C_in * 2 * C, 2 * C, C * 2 * C, 2 * C, C_in * C, C)
    grads = empty(sum(sizes))
    dx, dg, act = empty(B, L, C_in), empty(B, L, 2 * C), empty(B, L, C)
    part = empty(lib.wst_fused_block_bwd_slices(), grads.numel())
    woT = out_w.T.contiguous()
    wgT = gate_w.transpose(1, 2).contiguous()
    wrT = res_w.T.contiguous()
    with torch.cuda.device(dev):
        rc = lib.wst_fused_gated_block_bwd_f32(
            x.data_ptr(), dresid.data_ptr(), dskip.data_ptr(), gate_w.data_ptr(),
            gate_b.data_ptr(), woT.data_ptr(), wgT.data_ptr(), wrT.data_ptr(),
            dx.data_ptr(), grads.data_ptr(), dg.data_ptr(), act.data_ptr(),
            part.data_ptr(), B, L, C_in, C, K, dilation,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fused_gated_block_bwd")
    fused_gated_block_bwd.launches += 1
    dwg, dbg, dwo, dbo, dwr, dbr = torch.split(grads, sizes)
    return (dx, dwg.view(K, C_in, 2 * C), dbg, dwo.view(C, 2 * C), dbo,
            dwr.view(C_in, C), dbr)


fused_gated_block_bwd.launches = 0
