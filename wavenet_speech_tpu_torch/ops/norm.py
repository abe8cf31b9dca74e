"""Normalizations (wavenet_speech_tpu/ops/norm.py): the batch
standardization of raw signals and the reference's channel LayerNorm.

The reference's LayerNorm (modules/layernorm.py:11-28) computes
``gamma * (x - mean) / (std + eps) + beta`` with the Bessel-corrected
(ddof=1) std, torch's ``Tensor.std`` default, and eps added to the std, not
to the variance (PARITY.md:15). It is kept so, not as ``nn.LayerNorm``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wavenet_speech_tpu_torch.parallel.collectives import mean_var


def batch_standardize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x normalized to zero mean and unit (biased) variance over every axis
    but the last: the training-mode statistics of the reference's
    ``nn.BatchNorm1d(1)`` base model, without its affine (the conv that
    follows absorbs it). Padding frames count in the statistics, as in the
    reference. Inside ``parallel.collectives.batch_stats`` (the CTC step's
    ``preprocess`` on a mesh) the statistics are the global batch's, over
    every rank of the "data" and "seq" lines."""
    mean, var, _ = mean_var(x, tuple(range(x.dim() - 1)))
    return (x - mean) * torch.rsqrt(var + eps)


class LayerNorm(nn.Module):
    """Normalizes over ``axis`` (the channel axis, last in NLC) with the
    reference's numerics (see the module docstring)."""

    def __init__(self, features: int, eps: float = 1e-6, axis: int = -1, *, device=None):
        super().__init__()
        self.features, self.eps, self.axis = features, eps, axis
        self.gamma = nn.Parameter(torch.ones((features,), device=device))
        self.beta = nn.Parameter(torch.zeros((features,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.fill_(0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=self.axis, keepdim=True)
        n = x.shape[self.axis]
        var = ((x - mean) ** 2).sum(dim=self.axis, keepdim=True) / max(n - 1, 1)
        shape = [1] * x.dim()
        shape[self.axis] = self.features
        return self.gamma.reshape(shape) * (x - mean) / (torch.sqrt(var) + self.eps) \
            + self.beta.reshape(shape)
