"""Small tensor helpers (wavenet_speech_tpu/ops/fns.py; reference
modules/fns.py:6-15, legacy_code/model_tuning.py:4-17)."""
from __future__ import annotations

import torch


def one_hot_encoding(labels: torch.Tensor, num_labels: int, axis: int = -1) -> torch.Tensor:
    """(B, L) int -> float32 one-hot along ``axis`` (last by default, NLC;
    the reference's fns.py gives (B, num_labels, L))."""
    out = torch.nn.functional.one_hot(labels.long(), num_labels).float()
    return out if axis == -1 else torch.movedim(out, -1, axis)


def compute_receptive_field(dilation_depth: int, nb_stacks: int,
                            kernel_width: int = 2) -> int:
    """Receptive field of nb_stacks cycles of dilations [1, 2, ...,
    2^dilation_depth] (reference legacy_code/model_tuning.py:4-17)."""
    cycle = sum((kernel_width - 1) * (2 ** i) for i in range(dilation_depth + 1))
    return nb_stacks * cycle + 1
