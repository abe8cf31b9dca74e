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

The blocks, centred (the default) or with ``causal=True`` causal, run the
fused block, which is its kernels on the card (``models.blocks``).

Under sequence parallelism (``parallel.halo.seq_axis``; JAX's
raw_ctcnet.py:120-155) the featurizer, which lengthens the time axis by
h = fk - 1, runs shard by shard: the valid conv over the shard with h
frames of halo on both sides gives the global frames [s*Ls, s*Ls + Ls + h)
on shard s, of which each shard keeps its even share of the L + h global
frames, Ls + h/n starting at s * h/n (so n must divide h, JAX's
ValueError). The positions are global frame indices. The blocks after it
exchange their own halos (``models.blocks``).

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
from wavenet_speech_tpu_torch.parallel.halo import current_seq_axis, halo_pad

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
        h = self.feature_kwidth - 1
        mesh = current_seq_axis()
        if mesh is not None and h > 0:
            n, i = mesh.axis_size("seq"), mesh.axis_index("seq")
            if h % n:
                raise ValueError(
                    f"sequence-sharded RawCTCNet needs seq shards ({n}) to divide "
                    f"feature_kwidth-1 ({h}) so the L+fk-1 output shards evenly; "
                    f"pick fk == 1 (mod n_seq)")
            v = _conv1d(halo_pad(seq, h, h, mesh), self.feat_conv.w, dilation=1,
                        pad_left=0, pad_right=0)               # (B, Ls + h, F)
            share = h // n
            out = v[:, i * share:i * share + seq.shape[1] + share]
        else:
            out = _conv1d(seq, self.feat_conv.w, dilation=1, pad_left=h, pad_right=h)
        out = leaky_relu(out + self.feat_conv.b)
        out = leaky_relu(out @ self.feat_1x1.w[0] + self.feat_1x1.b)
        if self.positions:
            pos = torch.arange(out.shape[1], dtype=out.dtype, device=out.device)[None, :, None]
            if mesh is not None:   # the global frame index
                pos = pos + mesh.axis_index("seq") * out.shape[1]
            p = self.positions_1x1
            out = out + hardtanh(pos @ p.w + p.b)
        out, skip = self.input_block(out)
        skips = skip @ self.input_bottleneck.w + self.input_bottleneck.b
        out, skips = self.stack(out, skips)
        h = self.out1(leaky_relu(skips))
        h = self.out2(leaky_relu(h))
        return torch.softmax(h, dim=-1) if self.softmax else h
