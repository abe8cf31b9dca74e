"""Elementwise activations (wavenet_speech_tpu/ops/activations.py:9-26)."""
from __future__ import annotations

import torch


def gated_activation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """tanh(x) * sigmoid(y) — the WaveNet gate."""
    return torch.tanh(x) * torch.sigmoid(y)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """LeakyReLU(0.01), as in every output stack of the reference."""
    return torch.where(x >= 0, x, negative_slope * x)


def hardtanh(x: torch.Tensor, min_val: float = -1.0, max_val: float = 1.0) -> torch.Tensor:
    """nn.Hardtanh: x clipped to [min_val, max_val] (RawCTCNet's position
    mixer)."""
    return torch.clamp(x, min_val, max_val)
