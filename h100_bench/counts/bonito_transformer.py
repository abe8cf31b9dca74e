"""FLOPs and bytes of the bonito_transformer family, two FLOPs a
multiply-add, from shapes alone.

``read_flops``: one read's forward over the products: the stem's
convolutions, each layer's Wqkv, out_proj, W1 and W2 on the T stem frames,
the band's QK^T and PV (4 H dh a query-key pair of the band, clipped at
the ends), the upsample on T frames and the head on its 2T. RoPE, RMSNorm,
SwiGLU's gate and the loss are left out. It has no causal block.

``window_attn``: the least work of the band kernel's forward and backward
over one layer of B chunks: 4 B H band dh FLOPs forward (QK^T, PV) and
8 B H band dh backward (dV, dP, dQ, dK; the scores' recompute is the
implementation's choice and not counted), and the bytes, float32, of the
two launches apart: the forward reads q, k, v and writes o, the backward
reads q, k, v, o, dO and writes dq, dk, dv (the log-sum-exp, 1/64 of a
tensor, is left out)."""
from __future__ import annotations

from typing import Sequence, Tuple

from h100_bench.reference.bonito_transformer import stem_frames

F32 = 4


def band(T: int, window: Sequence[int]) -> int:
    """Query-key pairs of the band over T frames, clipped at the ends."""
    left, right = window
    return sum(min(T - 1, i + right) - max(0, i - left) + 1 for i in range(T))


def read_flops(cfg, L: int) -> float:
    m = cfg["model"]
    d, f, H = m["d_model"], m["dim_feedforward"], m["nhead"]
    flops, frames = 0.0, L
    for c_in, c_out, k, stride in m["stem"]:
        frames = (frames + 2 * (k // 2) - k) // stride + 1
        flops += 2.0 * k * c_in * c_out * frames
    T = stem_frames(cfg, L)
    layer = 2.0 * T * (d * 3 * d + d * d + d * 2 * f + f * d)
    layer += 4.0 * H * (d // H) * band(T, m["attn_window"])
    flops += m["depth"] * layer
    flops += 2.0 * T * d * m["upsample"] * d + 2.0 * m["upsample"] * T * d * m["num_labels"]
    return flops


def causal_layers(cfg):
    return []


def window_attn(B: int, T: int, W: Sequence[int], H: int, dh: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's band attention, forward and backward,
    over B chunks of T frames, window W = (left, right), H heads of dh."""
    flops = 12.0 * B * H * band(T, W) * dh
    nbytes = F32 * (4.0 + 8.0) * B * T * H * dh
    return flops, nbytes
