"""Weights made from the seed on the device, in a few large calls: one
uniform draw for every kernel and, where the configuration asks for noise,
one normal draw, cut into leaves by name.

Kernels are uniform with the variance ``init.kernel_variance`` / fan_in
(fan_in the product of all but the last axis), skip bottlenecks the
identity, biases zero, and bottlenecks and biases plus ``init.noise`` times
N(0, 1). The port's initialiser gives kernels the variance 2 / fan_in; the
configurations take 1 / fan_in, under which the residual stream grows by
a sum and not by a product of the blocks' gains, so that two float32
implementations of the model agree to rounding and the check can tell a
sound run from a fault (PERF.md). The same
seed on the same device gives the same tensors, so the reference remakes
them after the window instead of keeping a copy."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from h100_bench import reference


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, stream]).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)


def make(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on device} for every parameter of cfg."""
    shapes = reference.family(cfg["family"]).param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    noise = cfg["init"]["noise"]
    variance = cfg["init"]["kernel_variance"]
    if noise:
        flat_noise = torch.empty(sum(sizes), device=device).normal_(generator=gen)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        leaf = name.rsplit(".", 1)[-1]
        w = flat[off:off + n].view(shape)
        if leaf in ("b", "gate_b", "out_b", "res_b"):
            w = torch.zeros_like(w)
        elif "bottleneck" in name:
            w = torch.eye(shape[0], shape[1], device=device)
        else:
            w = w * math.sqrt(3.0 * variance / math.prod(shape[:-1]))
        if noise and (leaf in ("b", "gate_b", "out_b", "res_b") or "bottleneck" in name):
            w = w + noise * flat_noise[off:off + n].view(shape)
        out[name] = w.contiguous()
        off += n
    return out
