"""WaveNet generative stack (wavenet_speech_tpu/models/wavenet.py:25-90).

entry CausalConv1d -> gated residual blocks with eye-init 1x1 skip
bottlenecks summed -> LeakyReLU -> 1x1 -> LeakyReLU -> 1x1 -> optional
softmax. Tensors are NLC.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from wavenet_speech_tpu_torch.models.stack import LayerSpec, SkipSumStack
from wavenet_speech_tpu_torch.ops.activations import leaky_relu
from wavenet_speech_tpu_torch.ops.conv import CausalConv1d, Conv1x1


class WaveNet(nn.Module):
    def __init__(self, in_dim: int, entry_kwidth: int,
                 layers: Sequence[LayerSpec], out_dim: int,
                 softmax: bool = True, *, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.layers = tuple(tuple(l) for l in layers)
        self.softmax = softmax
        self.entry = CausalConv1d(in_dim, self.layers[0][0], entry_kwidth,
                                  device=device)
        self.stack = SkipSumStack(self.layers, out_dim, causal=True,
                                  device=device)
        self.out1 = Conv1x1(out_dim, out_dim, device=device)
        self.out2 = Conv1x1(out_dim, out_dim, device=device)

    @property
    def receptive_field(self) -> int:
        return self.entry.w.shape[0] + sum((k - 1) * d
                                           for (_, _, k, d) in self.layers)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for m in (self.entry, self.stack, self.out1, self.out2):
            m.reset_parameters(generator)

    def forward(self, signal):
        """signal (B, L, in_dim) -> (B, L, out_dim), softmaxed if
        self.softmax."""
        out = self.entry(signal)
        _, skips = self.stack(out)
        h = self.out1(leaky_relu(skips))
        h = self.out2(leaky_relu(h))
        return torch.softmax(h, dim=-1) if self.softmax else h
