"""WaveNetClassifier: the CTC head over WaveNet's features
(wavenet_speech_tpu/models/classifier.py:24-85).

AvgPool1d downsample -> non-causal input ResidualBlock + eye-init skip
bottleneck -> non-causal residual stack with skip sum -> LeakyReLU -> 1x1
-> LeakyReLU -> 1x1 to num_labels -> optional softmax.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.models.stack import LayerSpec, SkipSumStack
from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops.activations import leaky_relu
from wavenet_speech_tpu_torch.ops.conv import Conv1x1, Dense
from wavenet_speech_tpu_torch.parallel.halo import current_seq_axis


def avg_pool1d(x, kernel_size: int):
    """nn.AvgPool1d(kernel) over NLC: stride = kernel, no padding, output
    length floor(L / kernel). Under ``seq_axis`` each time shard pools its
    own frames, which equals the whole sequence's pool only when
    L_shard % kernel == 0 (parallel/halo.py:84-85); otherwise it raises."""
    B, L, C = x.shape
    if current_seq_axis() is not None and L % kernel_size:
        raise ValueError(f"avg_pool1d under sequence parallelism: the shard length "
                         f"{L} is not a multiple of the pool {kernel_size}")
    Lo = L // kernel_size
    return x[:, : Lo * kernel_size].reshape(B, Lo, kernel_size, C).mean(dim=2)


class WaveNetClassifier(nn.Module):
    def __init__(self, in_dim: int, num_labels: int,
                 layers: Sequence[LayerSpec], out_dim: int,
                 pool_kernel_size: int = 2, input_kernel_size: int = 2,
                 input_dilation: int = 1, softmax: bool = True, *, device=None):
        super().__init__()
        self.layers = tuple(tuple(l) for l in layers)
        self.pool_kernel_size = pool_kernel_size
        self.softmax = softmax
        c0 = self.layers[0][0]
        self.input_block = ResidualBlock(in_dim, c0, input_kernel_size,
                                         input_dilation, causal=False,
                                         device=device)
        self.input_bottleneck = Dense(c0, out_dim, w_init=init.eye,
                                      device=device)
        self.stack = SkipSumStack(self.layers, out_dim, causal=False,
                                  device=device)
        self.out1 = Conv1x1(out_dim, out_dim, device=device)
        self.out2 = Conv1x1(out_dim, num_labels, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for m in (self.input_block, self.input_bottleneck, self.stack,
                  self.out1, self.out2):
            m.reset_parameters(generator)

    def forward(self, seq):
        """seq (B, L, in_dim) -> (B, floor(L / pool), num_labels)."""
        out = avg_pool1d(seq, self.pool_kernel_size)
        out, skip = self.input_block(out)
        skips = skip @ self.input_bottleneck.w + self.input_bottleneck.b
        out, skips = self.stack(out, skips)
        h = self.out1(leaky_relu(skips))
        h = self.out2(leaky_relu(h))
        return torch.softmax(h, dim=-1) if self.softmax else h
