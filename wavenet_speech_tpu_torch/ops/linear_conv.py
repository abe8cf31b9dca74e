"""Linearized (incremental) convolution, the fast-generation primitive
(wavenet_speech_tpu/ops/linear_conv.py; reference
modules/linear_conv_ops.py:20-73, 112-123): a causal dilated conv's last
output frame, computed from one receptive-field window as a gather of the
kernel's taps and one product."""
from __future__ import annotations

import numpy as np
import torch

from wavenet_speech_tpu_torch.ops.conv import receptive_field


def ker_ixs(dilation: int, kernel_width: int) -> np.ndarray:
    """The frames of a receptive-field window that a dilated kernel's taps
    read (reference get_ker_ixs)."""
    total = kernel_width * dilation - (dilation - 1)
    return np.arange(0, total, dilation)


def linear_conv_step(frame: torch.Tensor, w: torch.Tensor, b=None, *,
                     dilation: int = 1) -> torch.Tensor:
    """One output frame of a causal dilated conv. frame (B, rf, C_in), the
    last rf = k + (d-1)(k-1) input frames; w (K, C_in, C_out); b (C_out,).
    Returns (B, C_out), equal to ``causal_conv1d(frame, w, b)[:, -1]``."""
    k = w.shape[0]
    rf = receptive_field(k, dilation)
    if frame.shape[1] != rf:
        raise ValueError(f"window of {frame.shape[1]} frames, the kernel's receptive field "
                         f"is {rf}")
    taps = frame[:, torch.as_tensor(ker_ixs(dilation, k), device=frame.device)]
    out = torch.einsum("bkc,kcd->bd", taps, w)
    return out if b is None else out + b
