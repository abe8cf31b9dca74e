"""The least work of the port's kernels at a shape: the algorithm's FLOPs
(two per multiply-add) and its bytes (each input read once, each output
written once), float32.

The fused gated block (B4) over `rows` frames of (c_in -> c, k taps):
    gate conv k*c_in*2c, the fused 1x1 c*2c, the residual projection c_in*c
a frame; it reads x and the weights and writes resid and skip. Its
backward (B5) takes dx and the weight gradient of each of those products,
twice the forward's FLOPs, and not the gate recompute, which is a choice of
the implementation; it reads x, dresid, dskip and the weights and writes dx
and the weight gradients."""
from __future__ import annotations

from typing import Tuple

F32 = 4


def _weights(c_in: int, c: int, k: int) -> int:
    return k * c_in * 2 * c + 2 * c + c * 2 * c + 2 * c + c_in * c + c


def fused_block_fwd(rows: int, c_in: int, c: int, k: int) -> Tuple[float, float]:
    flops = 2.0 * rows * (k * c_in * 2 * c + c * 2 * c + c_in * c)
    nbytes = F32 * (rows * (c_in + 2 * c) + _weights(c_in, c, k))
    return flops, float(nbytes)


def fused_block_bwd(rows: int, c_in: int, c: int, k: int) -> Tuple[float, float]:
    flops = 2.0 * fused_block_fwd(rows, c_in, c, k)[0]
    nbytes = F32 * (rows * (2 * c_in + 2 * c) + 2 * _weights(c_in, c, k))
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)
