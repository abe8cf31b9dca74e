"""Parameter initializers of wavenet_speech_tpu/nn/initializers.py:21-79 on
an explicit ``torch.Generator``.

Each returns a new float32 CPU tensor of ``shape``; modules copy it onto
their device, so one seed gives the same weights on every device. Shapes
follow the JAX layout: conv kernels (K, C_in, C_out), dense kernels
(C_in, C_out).

The defaults of ``nn.Conv1d`` / ``nn.Linear`` (kaiming-uniform with
a = sqrt(5)) give another bound and are not used.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

Shape = Tuple[int, ...]


def _fan_in(shape: Shape) -> int:
    if len(shape) == 3:  # (K, C_in, C_out) conv kernel
        return shape[0] * shape[1]
    if len(shape) == 2:  # (C_in, C_out) dense kernel
        return shape[0]
    return math.prod(shape[:-1])


def kaiming_uniform(shape: Shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_ with a=0, fan_in, leaky_relu gain:
    U(-b, b) with b = sqrt(6 / fan_in), fan_in = K*C_in (conv) or C_in
    (dense)."""
    bound = math.sqrt(6.0 / _fan_in(shape))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def kaiming_normal(shape: Shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch.nn.init.kaiming_normal_'s default: N(0, sqrt(2 / fan_in)),
    fan_in as in kaiming_uniform."""
    return math.sqrt(2.0 / _fan_in(shape)) * torch.randn(shape, generator=generator)


def eye(shape: Shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Identity init for (1, C_in, C_out) 1x1 conv or (C_in, C_out) dense
    kernels; rectangular identity when C_in != C_out."""
    del generator
    if len(shape) == 3:
        k, cin, cout = shape
        if k != 1:
            raise ValueError("eye init only valid for 1x1 convs")
        return torch.eye(cin, cout)[None]
    cin, cout = shape
    return torch.eye(cin, cout)


def zeros(shape: Shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    del generator
    return torch.zeros(shape)


def _noisy(base_init, eps: float, shape: Shape,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return base_init(shape, generator) + eps * torch.randn(shape, generator=generator)


def with_noise(base_init, eps: float):
    """base_init plus eps * N(0, 1) noise, drawn from the same generator
    (the RawCTCNet init: eye or zeros + 1e-4 noise). A partial of a
    module-level function, so a module holding it pickles (to the ranks
    of ``parallel.run_ranks``)."""
    return functools.partial(_noisy, base_init, eps)
