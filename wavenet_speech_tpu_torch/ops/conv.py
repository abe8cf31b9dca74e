"""Length-preserving dilated 1-D convolutions over NLC tensors
(wavenet_speech_tpu/ops/conv.py:35-46, 116-154, 157-250).

Padding is explicit and asymmetric, as in the JAX package:

  * causal: (k-1)*d frames on the left, none on the right;
  * non-causal: ``autopad`` on the left and the rest on the right, so an
    odd total puts the extra frame on the LEFT. ``padding='same'`` in torch
    puts it on the right and would shift every k=2 classifier block by one
    frame.

Kernels are (K, C_in, C_out), as in the JAX package, and are permuted to
torch's (C_out, C_in, K) at the call.

Under sequence parallelism (``parallel.halo.seq_axis``) the padding is
replaced by halos from the neighbouring time shards (ops/conv.py:116-154):
a causal conv takes its (k-1)*d left frames from the previous shard, a
non-causal one its ``autopad`` left frames from the previous shard and the
rest from the next. The shards at the ends of the line get zeros, which is
the padding of the whole sequence.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.parallel.halo import current_seq_axis, halo_pad


def receptive_field(kernel_width: int, dilation: int) -> int:
    """k + (d-1)(k-1), as in reference modules/conv_ops.py:37."""
    return kernel_width + (dilation - 1) * (kernel_width - 1)


def autopad(kernel_width: int, dilation: int) -> int:
    """Left-side padding for the length-preserving non-causal conv
    (reference modules/conv_ops.py:104-116)."""
    total = (kernel_width - 1) * dilation
    if total % 2 == 1:
        return (total - 1) // 2 + 1
    return total // 2


def _conv1d(x, w, *, dilation: int, pad_left: int, pad_right: int):
    """Dilated cross-correlation of x (B, L, C_in) with w (K, C_in, C_out)
    under explicit padding; returns a contiguous (B, L_out, C_out)."""
    xp = F.pad(x.transpose(1, 2), (pad_left, pad_right))
    out = F.conv1d(xp, w.permute(2, 1, 0), dilation=dilation)
    return out.transpose(1, 2).contiguous()


def causal_conv1d(x, w, b=None, *, dilation: int = 1):
    """Length-preserving causal dilated conv. x: (B, L, C_in),
    w: (K, C_in, C_out), b: (C_out,). Under ``seq_axis`` the left padding
    is the previous shard's halo."""
    pad = (w.shape[0] - 1) * dilation
    mesh = current_seq_axis()
    if mesh is not None and pad > 0:
        x, pad = halo_pad(x, pad, 0, mesh), 0
    out = _conv1d(x, w, dilation=dilation, pad_left=pad, pad_right=0)
    return out if b is None else out + b


def noncausal_conv1d(x, w, b=None, *, dilation: int = 1):
    """Length-preserving auto-padded (non-causal) dilated conv; halos on
    both sides under ``seq_axis``."""
    k = w.shape[0]
    left = autopad(k, dilation)
    right = (k - 1) * dilation - left
    mesh = current_seq_axis()
    if mesh is not None and left + right > 0:
        x, left, right = halo_pad(x, left, right, mesh), 0, 0
    out = _conv1d(x, w, dilation=dilation, pad_left=left, pad_right=right)
    return out if b is None else out + b


Init = Callable[..., torch.Tensor]


class _Conv(nn.Module):
    conv = staticmethod(causal_conv1d)

    def __init__(self, in_channels: int, out_channels: int, kernel_width: int,
                 dilation: int = 1, *, w_init: Init = init.kaiming_uniform,
                 b_init: Init = init.zeros, device=None):
        super().__init__()
        self.dilation = dilation
        self.w_init, self.b_init = w_init, b_init
        self.w = nn.Parameter(torch.empty(
            (kernel_width, in_channels, out_channels), device=device))
        self.b = nn.Parameter(torch.empty((out_channels,), device=device))

    @property
    def receptive_field(self) -> int:
        return receptive_field(self.w.shape[0], self.dilation)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.w.copy_(self.w_init(tuple(self.w.shape), generator))
            self.b.copy_(self.b_init(tuple(self.b.shape), generator))

    def forward(self, x):
        return self.conv(x, self.w, self.b, dilation=self.dilation)


class CausalConv1d(_Conv):
    """Causal dilated conv (reference modules/conv_ops.py:8-44)."""


class NonCausalConv1d(_Conv):
    """Auto-padded dilated conv (reference modules/conv_ops.py:47-79)."""

    conv = staticmethod(noncausal_conv1d)


class Dense(nn.Module):
    """Dense layer on the trailing axis: x @ w + b with w (C_in, C_out)."""

    def __init__(self, in_features: int, out_features: int, *,
                 w_init: Init = init.kaiming_uniform, b_init: Init = init.zeros,
                 device=None):
        super().__init__()
        self.w_init, self.b_init = w_init, b_init
        self.w = nn.Parameter(torch.empty((in_features, out_features),
                                          device=device))
        self.b = nn.Parameter(torch.empty((out_features,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.w.copy_(self.w_init(tuple(self.w.shape), generator))
            self.b.copy_(self.b_init(tuple(self.b.shape), generator))

    def forward(self, x):
        return x @ self.w + self.b


# A 1x1 conv is a per-timestep dense layer; the JAX package names both.
Conv1x1 = Dense
