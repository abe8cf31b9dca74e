"""RawCTCNet: the CTC classifier over the raw float waveform
(wavenet_speech_tpu/models/raw_ctcnet.py:36-167).

featurizer conv (1 -> num_features, padded by fk-1 on BOTH sides with no
slice, so the output is L + fk - 1 frames, a quirk of the reference kept
by the JAX package) -> LeakyReLU -> 1x1 -> LeakyReLU -> optional
position-mixing 1x1 + Hardtanh added in -> input ResidualBlock -> eye+noise
input bottleneck -> residual stack with skip sum -> LeakyReLU -> 1x1 ->
LeakyReLU -> 1x1 to num_labels -> optional softmax.

Init (raw_ctcnet.py:29-31, 65-100): kaiming-uniform weights; eye + 1e-4
noise bottlenecks and position mixer; zero + 1e-4 noise biases.

Non-causal blocks (the default) run the composite; with ``causal=True`` the
blocks run the fused block, which is its kernel on the card. The JAX
package's sequence-sharded featurizer (raw_ctcnet.py:125-140) is not
ported: under ``parallel.halo.seq_axis`` the forward raises.

It trains behind ``facade.BatchNorm1d`` through the joint step with
``JointLoss("ctc")`` (the CLI's raw-ctcnet), or alone through
``training.make_ctc_train_step``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.models.stack import LayerSpec, SkipSumStack
from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops.activations import hardtanh, leaky_relu
from wavenet_speech_tpu_torch.ops.conv import CausalConv1d, Dense, _conv1d
from wavenet_speech_tpu_torch.parallel.halo import current_seq_axis

EPS = 1e-4
noisy_zeros = init.with_noise(init.zeros, EPS)
noisy_eye = init.with_noise(init.eye, EPS)


class RawCTCNet(nn.Module):
    def __init__(self, num_features: int, feature_kwidth: int, num_labels: int,
                 layers: Sequence[LayerSpec], out_dim: int,
                 input_kernel_size: int = 2, input_dilation: int = 1,
                 positions: bool = False, softmax: bool = True,
                 causal: bool = False, *, device=None):
        super().__init__()
        F = num_features
        self.num_features, self.feature_kwidth = F, feature_kwidth
        self.layers = tuple(tuple(l) for l in layers)
        self.positions, self.softmax, self.causal = positions, softmax, causal
        c0 = self.layers[0][0]
        # the JAX tree's conv kernels: feat_conv.w (fk, 1, F), feat_1x1.w (1, F, F)
        self.feat_conv = CausalConv1d(1, F, feature_kwidth, b_init=noisy_zeros, device=device)
        self.feat_1x1 = CausalConv1d(F, F, 1, b_init=noisy_zeros, device=device)
        if positions:
            self.positions_1x1 = Dense(1, F, w_init=noisy_eye, b_init=noisy_zeros,
                                       device=device)
        self.input_block = ResidualBlock(F, c0, input_kernel_size, input_dilation,
                                         causal=causal, b_init=noisy_zeros, device=device)
        self.input_bottleneck = Dense(c0, out_dim, w_init=noisy_eye, b_init=noisy_zeros,
                                      device=device)
        self.stack = SkipSumStack(self.layers, out_dim, causal=causal, b_init=noisy_zeros,
                                  bottleneck_w_init=noisy_eye,
                                  bottleneck_b_init=noisy_zeros, device=device)
        self.out1 = Dense(out_dim, out_dim, b_init=noisy_zeros, device=device)
        self.out2 = Dense(out_dim, num_labels, b_init=noisy_zeros, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        parts = [self.feat_conv, self.feat_1x1] + \
            ([self.positions_1x1] if self.positions else []) + \
            [self.input_block, self.input_bottleneck, self.stack, self.out1, self.out2]
        for m in parts:
            m.reset_parameters(generator)

    def output_length(self, L):
        """The featurizer emits L + feature_kwidth - 1 frames."""
        return L + self.feature_kwidth - 1

    def forward(self, seq):
        """seq (B, L, 1) raw waveform -> (B, L + fk - 1, num_labels)."""
        if current_seq_axis() is not None:
            raise NotImplementedError(
                "RawCTCNet under sequence parallelism is not ported (ROADMAP A12)")
        h = self.feature_kwidth - 1
        out = _conv1d(seq, self.feat_conv.w, dilation=1, pad_left=h, pad_right=h)
        out = leaky_relu(out + self.feat_conv.b)
        out = leaky_relu(out @ self.feat_1x1.w[0] + self.feat_1x1.b)
        if self.positions:
            pos = torch.arange(out.shape[1], dtype=out.dtype, device=out.device)[None, :, None]
            p = self.positions_1x1
            out = out + hardtanh(pos @ p.w + p.b)
        out, skip = self.input_block(out)
        skips = skip @ self.input_bottleneck.w + self.input_bottleneck.b
        out, skips = self.stack(out, skips)
        h = self.out1(leaky_relu(skips))
        h = self.out2(leaky_relu(h))
        return torch.softmax(h, dim=-1) if self.softmax else h
