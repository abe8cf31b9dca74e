"""Gated residual block (wavenet_speech_tpu/models/blocks.py:30-91), and
the ByteNet blocks of ``models.ByteNetDecoder`` (blocks.py:95-220) at the
end of this file.

    gate   = tanh(conv_d(x)) * sigmoid(conv_d'(x))   # fused [tanh|sigmoid] conv
    resid  = conv1x1_r(gate) + dense(x)              # residual projection
    skip   = conv1x1_s(gate)                         # fused [resid|skip] 1x1

Parameters keep the JAX layout and names: ``gate_w`` (K, C_in, 2C),
``gate_b`` (2C,), ``out_w`` (1, C, 2C), ``out_b`` (2C,), ``res_w``
(C_in, C), ``res_b`` (C,).

Both kinds of block run the fused block ``ops.fused_block``: on the card
its forward and backward kernels (an autograd Function), on the CPU its
plain version, which autograd differentiates. Causal blocks (WaveNet's)
read their taps behind each frame; centred blocks (the classifier's,
RawCTCNet's) pad as ``noncausal_conv1d`` does, which the kernels take as a
tap origin (``ops.fused_block.tap_origin``). The JAX package runs its
centred blocks on the XLA composite: its kernel is causal only.

Under sequence parallelism (``parallel.halo.seq_axis``) the JAX package
leaves its kernel for the XLA composite, because the kernel zero-pads
where the halo should be (ops/pallas/residual_block.py:111-121). Here a
block runs the fused block on the window [left halo | shard | right halo]
(causal: (K-1)*d frames on the left; centred: ``autopad`` on the left and
the tap origin on the right) and keeps the shard's L_shard frames: the
kernels' zero padding reaches only frames that are dropped, and the
gradient of the halo rows flows back through the exchange. The outputs
equal the composite's; the kernels stay on the SP path at the cost of
(K-1)*d extra frames a block.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops.conv import (CausalConv1d, Conv1x1, causal_conv1d,
                                               receptive_field)
from wavenet_speech_tpu_torch.ops.fused_block import fused_gated_block, tap_origin
from wavenet_speech_tpu_torch.ops.norm import LayerNorm
from wavenet_speech_tpu_torch.parallel.halo import current_seq_axis, halo_pad


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_width: int,
                 dilation: int, causal: bool = True, *,
                 b_init: Callable = init.zeros, device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_width, self.dilation, self.causal = (kernel_width,
                                                         dilation, causal)
        self.b_init = b_init
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
        """Kaiming-uniform weights and ``b_init`` biases (zeros unless
        given), in the order of the JAX init (the numbers differ: torch and
        JAX generators differ)."""
        with torch.no_grad():
            for w, b in ((self.gate_w, self.gate_b), (self.out_w, self.out_b),
                         (self.res_w, self.res_b)):
                w.copy_(init.kaiming_uniform(tuple(w.shape), generator))
                b.copy_(self.b_init(tuple(b.shape), generator))

    def forward(self, x):
        """x (B, L, C_in) -> (residual_out, skip_out), each (B, L, C)."""
        K, d = self.kernel_width, self.dilation
        mesh = current_seq_axis()
        right = tap_origin(K, d, self.causal) if mesh is not None else 0
        left = (K - 1) * d - right if mesh is not None else 0
        if left + right:
            x = halo_pad(x, left, right, mesh)
        resid, skip = fused_gated_block(x, self.gate_w, self.gate_b, self.out_w[0],
                                        self.out_b, self.res_w, self.res_b, d,
                                        causal=self.causal)
        if left + right:
            L = x.shape[1] - left - right
            resid, skip = resid[:, left:left + L], skip[:, left:left + L]
        return resid, skip


# ---- ByteNet blocks (blocks.py:95-220): causal convs, which JAX computes as
# the composite ops/conv.causal_conv1d (no Pallas kernel), so conv1d here.
# Submodules and parameters carry the JAX tree's names: a JAX param tree
# flattened with "." is the state dict (``bridge.decoder_from_jax``).


class MultiplicativeUnit(nn.Module):
    """Causal multiplicative unit (reference block.py:192-225):
    sigma(g1) * tanh(sigma(g2) * h + sigma(g3) * tanh(u)), the four branch
    convs fused into one (K, C, 4C) causal conv ``w``. Init: kaiming-normal
    weights, zero + 1e-3 noise biases."""

    def __init__(self, ndim: int, kernel_width: int, dilation: int = 1, *, device=None):
        super().__init__()
        self.ndim, self.kernel_width, self.dilation = ndim, kernel_width, dilation
        self.w = nn.Parameter(torch.empty((kernel_width, ndim, 4 * ndim), device=device))
        self.b = nn.Parameter(torch.empty((4 * ndim,), device=device))

    @property
    def receptive_field(self) -> int:
        return receptive_field(self.kernel_width, self.dilation)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.w.copy_(init.kaiming_normal(tuple(self.w.shape), generator))
            self.b.copy_(init.with_noise(init.zeros, 1e-3)(tuple(self.b.shape), generator))

    def forward(self, h):
        C = self.ndim
        z = causal_conv1d(h, self.w, self.b, dilation=self.dilation)
        g1, g2, g3 = (torch.sigmoid(z[..., i * C:(i + 1) * C]) for i in range(3))
        return g1 * torch.tanh(g2 * h + g3 * torch.tanh(z[..., 3 * C:]))


def _halved_stack_params(modules, generator: Optional[torch.Generator]):
    """Each submodule's init in order, from one generator (JAX: one key a
    submodule, blocks.py:129-135)."""
    for m in modules:
        m.reset_parameters(generator)


class ResidualMUBlock(nn.Module):
    """ByteNet residual multiplicative block (reference block.py:86-126):
    x + [LN -> ReLU -> 1x1 halve -> LN -> ReLU -> MU(k, d) -> MU(1) ->
    1x1 double](x)."""

    def __init__(self, nchannels: int, kernel_width: int, dilation: int = 1, *, device=None):
        super().__init__()
        C, H = nchannels, nchannels // 2
        self.kernel_width, self.dilation = kernel_width, dilation
        self.ln_in = LayerNorm(C, device=device)
        self.down = Conv1x1(C, H, device=device)
        self.ln_mid = LayerNorm(H, device=device)
        self.mu_k = MultiplicativeUnit(H, kernel_width, dilation, device=device)
        self.mu_1 = MultiplicativeUnit(H, 1, 1, device=device)
        self.up = Conv1x1(H, C, device=device)

    @property
    def receptive_field(self) -> int:
        return receptive_field(self.kernel_width, self.dilation)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        _halved_stack_params((self.ln_in, self.down, self.ln_mid, self.mu_k, self.mu_1,
                              self.up), generator)

    def forward(self, x):
        h = self.down(torch.relu(self.ln_in(x)))
        h = self.mu_1(self.mu_k(torch.relu(self.ln_mid(h))))
        return x + self.up(h)


class ResidualReLUBlock(nn.Module):
    """ByteNet residual ReLU block (reference block.py:130-173):
    x + [LN -> ReLU -> 1x1 halve -> LN -> ReLU -> CausalConv(k, d) -> LN ->
    ReLU -> 1x1 double](x)."""

    def __init__(self, nchannels: int, kernel_width: int, dilation: int = 1, *, device=None):
        super().__init__()
        C, H = nchannels, nchannels // 2
        self.kernel_width, self.dilation = kernel_width, dilation
        self.ln_in = LayerNorm(C, device=device)
        self.down = Conv1x1(C, H, device=device)
        self.ln_mid = LayerNorm(H, device=device)
        self.conv = CausalConv1d(H, H, kernel_width, dilation, device=device)
        self.ln_out = LayerNorm(H, device=device)
        self.up = Conv1x1(H, C, device=device)

    @property
    def receptive_field(self) -> int:
        return receptive_field(self.kernel_width, self.dilation)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        _halved_stack_params((self.ln_in, self.down, self.ln_mid, self.conv, self.ln_out,
                              self.up), generator)

    def forward(self, x):
        h = self.down(torch.relu(self.ln_in(x)))
        h = self.conv(torch.relu(self.ln_mid(h)))
        return x + self.up(torch.relu(self.ln_out(h)))
