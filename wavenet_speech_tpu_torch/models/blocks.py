"""Gated residual block (wavenet_speech_tpu/models/blocks.py:30-91).

    gate   = tanh(conv_d(x)) * sigmoid(conv_d'(x))   # fused [tanh|sigmoid] conv
    resid  = conv1x1_r(gate) + dense(x)              # residual projection
    skip   = conv1x1_s(gate)                         # fused [resid|skip] 1x1

Parameters keep the JAX layout and names: ``gate_w`` (K, C_in, 2C),
``gate_b`` (2C,), ``out_w`` (1, C, 2C), ``out_b`` (2C,), ``res_w``
(C_in, C), ``res_b`` (C,).

Causal blocks (WaveNet's) run the fused block ``ops.fused_block``: on the
card its forward and backward kernels (an autograd Function), on the CPU
its plain version, which autograd differentiates. Non-causal blocks (the
classifier's) run the composite below, as in JAX, whose kernel is causal
only.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops.activations import gated_activation
from wavenet_speech_tpu_torch.ops.conv import noncausal_conv1d, receptive_field
from wavenet_speech_tpu_torch.ops.fused_block import fused_gated_block


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_width: int,
                 dilation: int, causal: bool = True, *, device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_width, self.dilation, self.causal = (kernel_width,
                                                         dilation, causal)
        C_in, C, K = in_channels, out_channels, kernel_width

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.gate_w = param(K, C_in, 2 * C)   # [0:C) tanh arm, [C:2C) sigmoid arm
        self.gate_b = param(2 * C)
        self.out_w = param(1, C, 2 * C)       # [0:C) residual arm, [C:2C) skip arm
        self.out_b = param(2 * C)
        self.res_w = param(C_in, C)
        self.res_b = param(C)

    @property
    def receptive_field(self) -> int:
        return receptive_field(self.kernel_width, self.dilation)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        """Kaiming-uniform weights and zero biases, in the order of the JAX
        init (the numbers differ: torch and JAX generators differ)."""
        with torch.no_grad():
            for w, b in ((self.gate_w, self.gate_b), (self.out_w, self.out_b),
                         (self.res_w, self.res_b)):
                w.copy_(init.kaiming_uniform(tuple(w.shape), generator))
                b.copy_(init.zeros(tuple(b.shape)))

    def forward(self, x):
        """x (B, L, C_in) -> (residual_out, skip_out), each (B, L, C)."""
        if self.causal:
            return fused_gated_block(x, self.gate_w, self.gate_b, self.out_w[0],
                                     self.out_b, self.res_w, self.res_b,
                                     self.dilation)
        C = self.out_channels
        g = noncausal_conv1d(x, self.gate_w, self.gate_b, dilation=self.dilation)
        act = gated_activation(g[..., :C], g[..., C:])
        o = act @ self.out_w[0] + self.out_b  # the 1x1 conv
        resid = o[..., :C] + (x @ self.res_w + self.res_b)
        return resid, o[..., C:]
