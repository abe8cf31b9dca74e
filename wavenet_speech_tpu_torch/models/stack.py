"""Residual-block stack with skip-sum bottlenecks
(wavenet_speech_tpu/models/stack.py:38-141), the shared core of WaveNet and
WaveNetClassifier.

The blocks are unrolled: PyTorch runs eagerly and has no scan, so the JAX
package's cycle-stacked parameter layout exists here only in the bridge
(``bridge.params_from_jax``), which unstacks it. The JAX ``remat`` option
is not ported: on the card the causal block saves only its input and its
backward kernel recomputes the gate, which is that remat inside the block.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.ops.conv import Dense

LayerSpec = Tuple[int, int, int, int]  # (c_in, c_out, kernel_width, dilation)


class SkipSumStack(nn.Module):
    """Residual blocks in sequence; each block's skip output passes through
    its own eye-initialised 1x1 bottleneck to out_dim, and those are summed.

    forward(x, skips0=None) -> (residual_out, skips_sum)"""

    def __init__(self, layers: Sequence[LayerSpec], out_dim: int,
                 causal: bool = True, *, device=None):
        super().__init__()
        self.layers = tuple(tuple(l) for l in layers)
        self.out_dim = out_dim
        self.blocks = nn.ModuleList(
            ResidualBlock(c_in, c_out, k, d, causal, device=device)
            for (c_in, c_out, k, d) in self.layers)
        self.bottlenecks = nn.ModuleList(
            Dense(c_out, out_dim, w_init=init.eye, device=device)
            for (_, c_out, _, _) in self.layers)

    @property
    def receptive_field(self) -> int:
        return 1 + sum((k - 1) * d for (_, _, k, d) in self.layers)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for blk, bn in zip(self.blocks, self.bottlenecks):
            blk.reset_parameters(generator)
            bn.reset_parameters(generator)

    def forward(self, x, skips0=None):
        B, L, _ = x.shape
        skips = (torch.zeros((B, L, self.out_dim), dtype=x.dtype, device=x.device)
                 if skips0 is None else skips0)
        out = x
        for blk, bn in zip(self.blocks, self.bottlenecks):
            out, skip = blk(out)
            skips = skips + skip @ bn.w + bn.b
        return out, skips
