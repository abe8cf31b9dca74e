"""Fused gated residual block, causal or centred: the CUDA counterpart of
wavenet_speech_tpu/ops/pallas/residual_block.py (``_kernel``, B4, launched
by ``_forward``; ``_bwd_kernel``, B5, launched by ``_pallas_bwd``), which is
causal only, and of the centred (non-causal) block's composite.

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

Padding: a causal block reads tap k at row t - (K-1-k) d, zeros before the
sequence; a centred block (``causal=False``) pads as ``ops.conv.
noncausal_conv1d`` does, ``autopad(K, d)`` rows on the left and the rest on
the right, so it reads tap k R = (K-1) d - autopad(K, d) rows later than the
causal block, with zeros past both ends (``tap_origin``). The kernels take R
as an origin in the taps' row coordinates; the residual 1x1 reads x
unshifted.

Types: float32, or bfloat16 as the TPU kernels take it (residual_block.py:
78-94, 245-300, 382-384), one type for every tensor of a call. Both types
run on the tensor cores (wgmma). float32 runs ``csrc/fused_block.cu`` and
``csrc/fused_block_bwd.cu``: every product is float32-accurate, taken as
three TF32 products over the split v = hi + lo (hi = tf32(v), lo = tf32(v -
hi), round to nearest, ties away), hi hi + hi lo + lo hi summed in float32,
on tiles that TMA copies into a ring of mbarrier-guarded slots
(``csrc/tma_tf32.cuh``); the call first splits the weights into hi and lo
planes. bf16 runs ``csrc/fused_block_bf16.cu`` and
``csrc/fused_block_bwd_bf16.cu`` (bf16 x bf16 -> float32, on shared-memory
tiles that cp.async fills): the forward multiplies bf16 values exactly,
sums in float32, adds the biases in float32, rounds ``act`` to bf16 before
the 1x1 product and stores the outputs rounded to bf16; the backward
recomputes the gate from bf16 x and weights, keeps dg and the (unrounded)
act float32 as the TPU kernel does, and takes each product with one of them
as two bf16 products over the split v = hi + lo (hi = bf16(v), lo = bf16(v -
hi)), summed in float32; dx and the summed gradients are rounded to bf16.
``fused_gated_block_kernel_ref`` does the forward's arithmetic in plain
PyTorch for either kind of block, and ``fused_gated_block_bwd_ref`` the
backward's. The plain version of the forward, ``fused_gated_block_ref``, is
that arithmetic for a causal block and, for a centred one, the composite it
replaces (in float32 the same function; in bf16 the composite rounds more
often than the kernel). The wrapper
passes the weights in the layouts the kernels read and zero-pads channel
widths that are not multiples of 32 (float32: one TMA box) or 8 (bf16),
cutting the outputs and gradients back; the kernels take any number of
taps. The float32 forward keeps ``act`` for its rows in shared memory up
to C = 512 (after padding); wider, it writes act to scratch in device
memory and reads it back in a second launch. A bf16 CUDA tensor goes
to the bf16 kernels or raises: it is never upcast to the float32 kernels.
``launches`` counts float32 launches and ``launches_bf16`` bf16 ones;
``fused_gated_block.launches_centred`` counts the forward launches of
centred blocks, of either type.

Where the time goes on an H100, at the bench shape (B=8, L=4505,
C_in=C=256, K=2): the forward is 33 GFLOP against ~115 MB moved (float32)
and the backward 85 GFLOP against ~150 MB, so both are bound by operations.
The forward keeps ``act`` and the (L, 2C) gate out of device memory and
reads each tap's rows of x separately (the TPU kernel's one contiguous halo
window is >500 KB at d=512, over a block's 227 KB of shared memory). The
backward writes dg and act once and reduces the weight gradients over
fixed frame slices. See the source notes in ``csrc/``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wavenet_speech_tpu_torch.ops import _build
from wavenet_speech_tpu_torch.ops.activations import gated_activation
from wavenet_speech_tpu_torch.ops.conv import _conv1d, autopad

_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/fused_block.cu: x, gate_w, gate_b, out_w, out_b, res_w, res_b, resid,
# skip, planes, act (or None); csrc/fused_block_bf16.cu: x, gate_w^T, gate_b,
# out_w^T, out_b, res_w^T, res_b, resid, skip; then B, L, C_in, C, K,
# dilation, tap origin; stream
_SIGNATURES = {"wst_fused_gated_block_f32": [_P] * 11 + [_I] * 7 + [_P],
               "wst_fused_block_max_channels": []}
_BF16_SIGNATURES = {"wst_fused_gated_block_bf16": [_P] * 9 + [_I] * 7 + [_P]}
# csrc/fused_block_bwd.cu: x, dresid, dskip, gate_w, gate_b, out_w, res_w,
# dx, grads, planes, da, dg, act, part; csrc/fused_block_bwd_bf16.cu: x,
# dresid, dskip, gate_w^T, gate_b, out_w, gate_w, res_w, dx, grads, dg's and
# act's hi/lo planes, da, part; then B, L, C_in, C, K, dilation, tap origin;
# stream
_BWD_SIGNATURES = {"wst_fused_gated_block_bwd_f32": [_P] * 14 + [_I] * 7 + [_P],
                   "wst_fused_block_bwd_slices": []}
_BWD_BF16_SIGNATURES = {"wst_fused_gated_block_bwd_bf16": [_P] * 14 + [_I] * 7 + [_P],
                        "wst_fused_block_bwd_bf16_slices": []}
_DTYPES = (torch.float32, torch.bfloat16)  # the storage types the kernels take
# channel widths the kernels take (float32: one 32-column TMA box; bf16:
# 16-byte rows); others are zero-padded
F32_ALIGN, BF16_ALIGN = 32, 8
# taps the backward kernels take in one pass of a reduction; more taps take
# more passes (csrc/fused_block_bwd*.cu), and the bf16 kernel then needs dx's
# float32 partial sums in its scratch (``_launch_bwd_bf16``)
MAX_TAPS = 8


def tap_origin(kernel_width: int, dilation: int, causal: bool) -> int:
    """Rows by which a block's taps read later than a causal block's: 0 for
    a causal block; for a centred one its right pad, (K-1) d less the left
    pad ``autopad(K, d)`` of ``noncausal_conv1d``."""
    return 0 if causal else (kernel_width - 1) * dilation - autopad(kernel_width, dilation)


def fused_gated_block_kernel_ref(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                                 dilation: int, causal: bool = True):
    """The kernels' arithmetic in plain PyTorch, for either kind of block:
    the conv as K shifted matmuls over the pad (``tap_origin``); in bf16
    widened to float32, ``act`` rounded to bf16 before the 1x1 product (the
    TPU kernel's act.astype(x.dtype)), the outputs rounded to bf16.

    Arguments as ``fused_gated_block_ref``; returns (resid, skip), each
    (B, L, C), in x's type."""
    K = gate_w.shape[0]
    L = x.shape[1]
    C = res_w.shape[1]
    h, R = (K - 1) * dilation, tap_origin(K, dilation, causal)
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, gate_w, gate_b, out_w, out_b, res_w, res_b = (
            t.float() for t in (x, gate_w, gate_b, out_w, out_b, res_w, res_b))
    xp = F.pad(x, (0, 0, h - R, R))
    g = gate_b + sum(xp[:, j * dilation: j * dilation + L] @ gate_w[j]
                     for j in range(K))
    act = gated_activation(g[..., :C], g[..., C:])
    if dtype == torch.bfloat16:
        act = act.to(dtype).float()
    o = act @ out_w + out_b
    resid = o[..., :C] + x @ res_w + res_b
    return resid.to(dtype), o[..., C:].to(dtype)


def fused_gated_block_ref(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                          dilation: int, causal: bool = True):
    """The plain version: the math of ``_xla_reference``
    (residual_block.py:44-55).

    x: (B, L, C_in); gate_w: (K, C_in, 2C); gate_b: (2C,); out_w: (C, 2C);
    out_b: (2C,); res_w: (C_in, C); res_b: (C,). Returns (resid, skip),
    each (B, L, C), in x's type.

    Causal: the kernels' arithmetic, ``fused_gated_block_kernel_ref``.

    Centred (``causal=False``): the composite that ResidualBlock ran for such
    blocks before the kernels took them, and that the JAX package runs, in
    x's type: ``noncausal_conv1d``'s conv over its pad, the gated
    activation, the 1x1s summed in its order. A CPU run gives the
    composite's bits. In float32 it is the kernels' function; in bf16 it
    rounds where the composite does (the conv's output, each operation),
    where the bf16 kernels keep float32 and round act and the outputs once
    (``fused_gated_block_kernel_ref``)."""
    if causal:
        return fused_gated_block_kernel_ref(x, gate_w, gate_b, out_w, out_b, res_w,
                                            res_b, dilation)
    K, C = gate_w.shape[0], res_w.shape[1]
    R = tap_origin(K, dilation, causal)
    g = _conv1d(x, gate_w, dilation=dilation, pad_left=(K - 1) * dilation - R,
                pad_right=R) + gate_b
    o = gated_activation(g[..., :C], g[..., C:]) @ out_w + out_b
    return o[..., :C] + (x @ res_w + res_b), o[..., C:]


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
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise ValueError(f"fused_gated_block: {name} is {t.dtype}; every "
                             f"tensor must be float32, or every one bfloat16")
        if not t.is_contiguous() or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"fused_gated_block: {name} must be contiguous "
                             f"and aligned to 4 values")
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
    if dilation < 1:
        raise ValueError(f"fused_gated_block: dilation must be >= 1, got {dilation}")
    return B, L, C_in, C, K


def _launch_fwd(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation: int,
                causal: bool = True):
    _, _, C_in, C, _ = _check_args(x, gate_w, gate_b, out_w, out_b, res_w,
                                   res_b, dilation)
    if x.dtype == torch.bfloat16:
        out = _launch_fwd_bf16(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation,
                               causal)
    else:
        (x, gate_w, gate_b, out_w, res_w, out_b, res_b), _, Cp = _pad_widths(
            F32_ALIGN, C_in, C, x, gate_w, gate_b, out_w, res_w, out_b=out_b, res_b=res_b)
        out = _unpad_outputs(_fwd_f32(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                                      dilation, causal), C, Cp)
    if not causal:
        fused_gated_block.launches_centred += 1
    return out


def _unpad_outputs(outputs, C: int, Cp: int):
    """(resid, skip) at a padded width Cp cut back to C, contiguous: the
    next block takes resid as its input."""
    return outputs if Cp == C else tuple(t[..., :C].contiguous() for t in outputs)


def _fwd_f32(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation: int,
             causal: bool = True):
    """B4 (csrc/fused_block.cu) at widths it takes (multiples of F32_ALIGN):
    the weights as stored, split in the call into hi and lo planes in
    ``planes``; above the kernel's widest act in shared memory, act goes
    through scratch."""
    B, L, C_in = x.shape
    K, C = gate_w.shape[0], res_w.shape[1]
    lib = _build.library("fused_block", _SIGNATURES)
    empty = lambda *s: torch.empty(s, device=x.device, dtype=torch.float32)
    resid, skip = empty(B, L, C), empty(B, L, C)
    planes = empty(2 * (K * 2 * C * C_in + 2 * C * C + C * C_in))
    act = empty(B, L, C) if C > lib.wst_fused_block_max_channels() else None
    with torch.cuda.device(x.device):
        rc = lib.wst_fused_gated_block_f32(
            x.data_ptr(), gate_w.data_ptr(), gate_b.data_ptr(),
            out_w.data_ptr(), out_b.data_ptr(), res_w.data_ptr(),
            res_b.data_ptr(), resid.data_ptr(), skip.data_ptr(), planes.data_ptr(),
            None if act is None else act.data_ptr(), B, L, C_in, C, K, dilation,
            tap_origin(K, dilation, causal), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fused_gated_block")
    _count(fused_gated_block, "f32")
    return resid, skip


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_last(t, n: int):
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _pad_halves(t, C: int, Cp: int):
    """A last dimension 2C = [C | C] zero-padded to [Cp | Cp]."""
    if C == Cp:
        return t
    return torch.cat([_pad_last(t[..., :C], Cp), _pad_last(t[..., C:], Cp)], -1)


def _unpad_halves(t, C: int, Cp: int):
    return t if C == Cp else torch.cat([t[..., :C], t[..., Cp:Cp + C]], -1)


def _pad_rows(t, n: int, dim: int):
    if t.shape[dim] == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, n - t.shape[dim]]
    return F.pad(t, pad)


def _pad_widths(align, C_in, C, x, gate_w, gate_b, out_w, res_w, cotangents=(),
                out_b=None, res_b=None):
    """The kernels' operands with C_in and C zero-padded to multiples of
    align (the identity at the model's widths). Zero channels change no
    result: their gate is 0 + 0, their act tanh(0) * sigmoid(0) = 0, and
    every weight row or column that reads them is zero."""
    Ci, Cp = _round_up(C_in, align), _round_up(C, align)
    contig = lambda t: None if t is None else t.contiguous()
    return [contig(t) for t in (
        _pad_last(x, Ci), _pad_rows(_pad_halves(gate_w, C, Cp), Ci, 1),
        _pad_halves(gate_b, C, Cp), _pad_rows(_pad_halves(out_w, C, Cp), Cp, 0),
        _pad_rows(_pad_last(res_w, Cp), Ci, 0),
        *(_pad_last(t, Cp) for t in cotangents),
        None if out_b is None else _pad_halves(out_b, C, Cp),
        None if res_b is None else _pad_last(res_b, Cp))], Ci, Cp


def _aligned(t):
    """t, or a copy of it whose data is 16-byte aligned (cp.async rows)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd_bf16(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation: int,
                     causal: bool = True):
    """B4-bf16 (csrc/fused_block_bf16.cu) with the weights K-major."""
    B, L, C_in = x.shape
    K, C = gate_w.shape[0], res_w.shape[1]
    (x, gate_w, gate_b, out_w, res_w, out_b, res_b), Ci, Cp = _pad_widths(
        BF16_ALIGN, C_in, C, x, gate_w, gate_b, out_w, res_w, out_b=out_b, res_b=res_b)
    wgT = gate_w.transpose(1, 2).contiguous()  # (K, 2C, C_in)
    woT = out_w.T.contiguous()                 # (2C, C)
    wrT = res_w.T.contiguous()                 # (C, C_in)
    x, gate_b, out_b, res_b = (_aligned(t) for t in (x, gate_b, out_b, res_b))
    resid = torch.empty((B, L, Cp), device=x.device, dtype=x.dtype)
    skip = torch.empty_like(resid)
    lib = _build.library("fused_block_bf16", _BF16_SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.wst_fused_gated_block_bf16(
            x.data_ptr(), wgT.data_ptr(), gate_b.data_ptr(), woT.data_ptr(),
            out_b.data_ptr(), wrT.data_ptr(), res_b.data_ptr(), resid.data_ptr(),
            skip.data_ptr(), B, L, Ci, Cp, K, dilation, tap_origin(K, dilation, causal),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fused_gated_block")
    _count(fused_gated_block, "bf16")
    return _unpad_outputs((resid, skip), C, Cp)


def _count(wrapper, suffix: str) -> None:
    if suffix == "f32":
        wrapper.launches += 1
    else:
        wrapper.launches_bf16 += 1


class _FusedGatedBlock(torch.autograd.Function):
    """B4 forward, B5 backward. Saves x and the weights only: the backward
    recomputes the gate, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation, causal):
        resid, skip = _launch_fwd(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                                  dilation, causal)
        ctx.save_for_backward(x, gate_w, gate_b, out_w, res_w)
        ctx.dilation, ctx.causal = dilation, causal
        return resid, skip

    @staticmethod
    def backward(ctx, dresid, dskip):
        x, gate_w, gate_b, out_w, res_w = ctx.saved_tensors
        dx, dwg, dbg, dwo, dbo, dwr, dbr = fused_gated_block_bwd(
            x, gate_w, gate_b, out_w, res_w, dresid.contiguous(),
            dskip.contiguous(), ctx.dilation, ctx.causal)
        return dx, dwg, dbg, dwo, dbo, dwr, dbr, None, None


def fused_gated_block(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                      dilation: int, causal: bool = True):
    """Fused gated residual block, causal or centred; see the module
    docstring.

    On a CPU tensor this is ``fused_gated_block_ref``. On a CUDA tensor it
    launches the kernels (float32 or bfloat16, contiguous) or raises; it
    never falls back. ``fused_gated_block.launches`` counts float32 forward
    launches, ``fused_gated_block.launches_bf16`` bf16 ones and
    ``fused_gated_block.launches_centred`` those of centred blocks."""
    if x.device.type == "cpu":
        return fused_gated_block_ref(x, gate_w, gate_b, out_w, out_b, res_w,
                                     res_b, dilation, causal)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gated_block: unsupported device {x.device}")
    return _FusedGatedBlock.apply(x, gate_w, gate_b, out_w, out_b, res_w, res_b,
                                  dilation, causal)


fused_gated_block.launches = fused_gated_block.launches_bf16 = 0
fused_gated_block.launches_centred = 0


def fused_gated_block_bwd_ref(x, gate_w, gate_b, out_w, res_w, dresid, dskip,
                              dilation: int, causal: bool = True):
    """The plain version of B5: the math of ``_bwd_kernel``
    (residual_block.py:201-300) with the gate recomputed over the whole
    sequence. Returns (dx, d gate_w, d gate_b, d out_w, d out_b, d res_w,
    d res_b), shaped as the forward's arguments. In bf16, the kernel's
    arithmetic: every input widened to float32, the results rounded to bf16
    (``_pallas_bwd``'s casts, residual_block.py:382-384)."""
    if x.dtype == torch.bfloat16:
        grads = fused_gated_block_bwd_ref(*(t.float() for t in (
            x, gate_w, gate_b, out_w, res_w, dresid, dskip)), dilation, causal)
        return tuple(g.to(torch.bfloat16) for g in grads)
    K, C_in, C2 = gate_w.shape
    B, L, _ = x.shape
    C = res_w.shape[1]
    h, R = (K - 1) * dilation, tap_origin(K, dilation, causal)
    xp = F.pad(x, (0, 0, h - R, R))
    taps = [xp[:, j * dilation: j * dilation + L] for j in range(K)]
    g = gate_b + sum(taps[j] @ gate_w[j] for j in range(K))
    th, sg = torch.tanh(g[..., :C]), torch.sigmoid(g[..., C:])
    act = th * sg
    do = torch.cat([dresid, dskip], dim=-1)
    da = do @ out_w.T
    dg = torch.cat([da * sg * (1.0 - th * th), da * th * sg * (1.0 - sg)], dim=-1)
    dgp = F.pad(dg, (0, 0, R, h - R))  # dx pulls dg from the frames that read it
    dx = dresid @ res_w.T
    for j in range(K):
        s = (K - 1 - j) * dilation
        dx = dx + dgp[:, s: s + L] @ gate_w[j].T
    rows = lambda t: t.reshape(B * L, t.shape[-1])
    dwg = torch.stack([rows(taps[j]).T @ rows(dg) for j in range(K)])
    return (dx, dwg, dg.sum(dim=(0, 1)), rows(act).T @ rows(do),
            do.sum(dim=(0, 1)), rows(x).T @ rows(dresid), dresid.sum(dim=(0, 1)))


def fused_gated_block_bwd(x, gate_w, gate_b, out_w, res_w, dresid, dskip,
                          dilation: int, causal: bool = True):
    """B5: the gradients of ``fused_gated_block`` (see
    ``fused_gated_block_bwd_ref``). On a CPU tensor this is the plain
    version; on a CUDA tensor it launches the kernel (float32 or bfloat16)
    or raises. ``fused_gated_block_bwd.launches`` counts float32 launches,
    ``fused_gated_block_bwd.launches_bf16`` bf16 ones."""
    if x.device.type == "cpu":
        return fused_gated_block_bwd_ref(x, gate_w, gate_b, out_w, res_w, dresid,
                                         dskip, dilation, causal)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gated_block_bwd: unsupported device {x.device}")
    return _launch_bwd(x, gate_w, gate_b, out_w, res_w, dresid, dskip, dilation, causal)


def _launch_bwd(x, gate_w, gate_b, out_w, res_w, dresid, dskip, dilation: int,
                causal: bool = True):
    _, _, C_in, C, _ = _check_args(x, gate_w, gate_b, out_w, None, res_w, None,
                                   dilation, dresid=dresid, dskip=dskip)
    if x.dtype == torch.bfloat16:
        return _launch_bwd_bf16(x, gate_w, gate_b, out_w, res_w, dresid, dskip, dilation,
                                causal)
    (x, gate_w, gate_b, out_w, res_w, dresid, dskip, _, _), _, Cp = _pad_widths(
        F32_ALIGN, C_in, C, x, gate_w, gate_b, out_w, res_w, (dresid, dskip))
    grads = _bwd_f32(x, gate_w, gate_b, out_w, res_w, dresid, dskip, dilation, causal)
    return _unpad_grads(grads, C_in, C, Cp)


def _bwd_f32(x, gate_w, gate_b, out_w, res_w, dresid, dskip, dilation: int,
             causal: bool = True):
    """B5 (csrc/fused_block_bwd.cu) at widths it takes (multiples of
    F32_ALIGN): (dx, dWg, dbg, dWo, dbo, dWr, dbr). The weights go as
    stored; the call splits them into hi and lo planes in scratch."""
    B, L, C_in = x.shape
    K, C = gate_w.shape[0], res_w.shape[1]
    lib = _build.library("fused_block_bwd", _BWD_SIGNATURES)
    dev = x.device
    empty = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)  # scratch
    grads = empty(K * C_in * 2 * C + 2 * C + C * 2 * C + 2 * C + C_in * C + C)
    dx = empty(B, L, C_in)
    planes = empty(2 * (2 * K * 2 * C * C_in + C * 2 * C + C_in * C))
    da, dg, act = empty(B, L, C), empty(B, L, 2 * C), empty(B, L, C)
    part = empty(lib.wst_fused_block_bwd_slices(), grads.numel())
    with torch.cuda.device(dev):
        rc = lib.wst_fused_gated_block_bwd_f32(
            x.data_ptr(), dresid.data_ptr(), dskip.data_ptr(), gate_w.data_ptr(),
            gate_b.data_ptr(), out_w.data_ptr(), res_w.data_ptr(), dx.data_ptr(),
            grads.data_ptr(), planes.data_ptr(), da.data_ptr(), dg.data_ptr(),
            act.data_ptr(), part.data_ptr(), B, L, C_in, C, K, dilation,
            tap_origin(K, dilation, causal), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fused_gated_block_bwd")
    _count(fused_gated_block_bwd, "f32")
    return (dx, *_split_grads(grads, K, C_in, C))


def _split_grads(grads, K: int, C_in: int, C: int):
    sizes = (K * C_in * 2 * C, 2 * C, C * 2 * C, 2 * C, C_in * C, C)
    dwg, dbg, dwo, dbo, dwr, dbr = torch.split(grads, sizes)
    return (dwg.view(K, C_in, 2 * C), dbg, dwo.view(C, 2 * C), dbo,
            dwr.view(C_in, C), dbr)


def _launch_bwd_bf16(x, gate_w, gate_b, out_w, res_w, dresid, dskip, dilation: int,
                     causal: bool = True):
    """B5-bf16 (csrc/fused_block_bwd_bf16.cu): gate_w^T for the gate
    recompute, out_w, gate_w and res_w as stored; dg and act go through
    scratch as bf16 hi and lo planes."""
    B, L, C_in = x.shape
    K, C = gate_w.shape[0], res_w.shape[1]
    (x, gate_w, gate_b, out_w, res_w, dresid, dskip, _, _), Ci, Cp = _pad_widths(
        BF16_ALIGN, C_in, C, x, gate_w, gate_b, out_w, res_w, (dresid, dskip))
    x, gate_b, dresid, dskip = (_aligned(t) for t in (x, gate_b, dresid, dskip))
    wgT = gate_w.transpose(1, 2).contiguous()
    lib = _build.library("fused_block_bwd_bf16", _BWD_BF16_SIGNATURES)
    dev, bf = x.device, torch.bfloat16
    n_grads = K * Ci * 2 * Cp + 2 * Cp + Cp * 2 * Cp + 2 * Cp + Ci * Cp + Cp
    grads = torch.empty(n_grads, device=dev, dtype=bf)
    dx = torch.empty((B, L, Ci), device=dev, dtype=bf)
    dgs = torch.empty((2, B, L, 2 * Cp), device=dev, dtype=bf)  # dg's hi, lo planes
    acts = torch.empty((2, B, L, Cp), device=dev, dtype=bf)     # act's hi, lo planes
    da = torch.empty((B, L, Cp), device=dev, dtype=torch.float32)
    # the weight gradients' slice sums; with more than MAX_TAPS taps, first
    # dx's float32 partial sums, one plane a group of MAX_TAPS taps
    dx_planes = -(-K // MAX_TAPS) if K > MAX_TAPS else 0
    part = torch.empty(max(lib.wst_fused_block_bwd_bf16_slices() * n_grads,
                           dx_planes * B * L * Ci), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        rc = lib.wst_fused_gated_block_bwd_bf16(
            x.data_ptr(), dresid.data_ptr(), dskip.data_ptr(), wgT.data_ptr(),
            gate_b.data_ptr(), out_w.data_ptr(), gate_w.data_ptr(), res_w.data_ptr(),
            dx.data_ptr(), grads.data_ptr(), dgs.data_ptr(), acts.data_ptr(),
            da.data_ptr(), part.data_ptr(), B, L, Ci, Cp, K, dilation,
            tap_origin(K, dilation, causal), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fused_gated_block_bwd")
    _count(fused_gated_block_bwd, "bf16")
    return _unpad_grads((dx, *_split_grads(grads, K, Ci, Cp)), C_in, C, Cp)


def _unpad_grads(grads, C_in: int, C: int, Cp: int):
    """The backward's outputs (dx, dWg, dbg, dWo, dbo, dWr, dbr) at widths
    padded by ``_pad_widths`` cut back to C_in and C."""
    dx, dwg, dbg, dwo, dbo, dwr, dbr = grads
    if (dx.shape[-1], Cp) == (C_in, C):
        return grads
    return (dx[..., :C_in], _unpad_halves(dwg[:, :C_in], C, Cp), _unpad_halves(dbg, C, Cp),
            _unpad_halves(dwo[:C], C, Cp), _unpad_halves(dbo, C, Cp), dwr[:C_in, :C], dbr[:C])


fused_gated_block_bwd.launches = fused_gated_block_bwd.launches_bf16 = 0
