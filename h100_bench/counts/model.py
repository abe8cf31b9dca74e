"""Forward FLOPs of a configuration's model, two per multiply-add, over
the products (convolutions and matrix products; activations, pooling and
the loss left out), as bench.py::_model_flops counts them. One module a
model family (``counts/<family>.py``, by the configuration's ``family``)
defines ``read_flops(cfg, L)``, the forward FLOPs of one read of L
samples, and ``causal_layers(cfg)``, the layers that run the fused causal
block (B4 forward, B5 backward)."""
from __future__ import annotations

import importlib
from typing import Iterable


def family(name: str):
    return importlib.import_module(f"h100_bench.counts.{name}")


def block_frame(c_in: int, c_out: int, k: int, out_dim: int) -> float:
    """One frame of a gated block (gate conv, fused 1x1, residual
    projection) and its skip bottleneck."""
    return 2.0 * (k * c_in * 2 * c_out + c_out * 2 * c_out + c_in * c_out + c_out * out_dim)


def forward_flops(cfg, lengths: Iterable[int]) -> float:
    """The forward FLOPs of reads of these lengths."""
    fn = family(cfg["family"]).read_flops
    return float(sum(fn(cfg, int(L)) for L in lengths))


def causal_layers(cfg):
    return family(cfg["family"]).causal_layers(cfg)
