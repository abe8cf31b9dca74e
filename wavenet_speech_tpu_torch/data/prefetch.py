"""Host -> device batches (wavenet_speech_tpu/data/prefetch.py).

``batch_to_device`` turns a host ``Batch`` into the dict of tensors the
train and eval steps take. On the card each array is copied from pinned
host memory with ``non_blocking=True``, so the copy is queued behind the
work already on the stream and the host goes on preparing the next batch.
``prefetch_to_device`` keeps ``size`` batches in flight that way.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, Union

import torch

from wavenet_speech_tpu_torch.data.common import Batch

FIELDS = ("signal", "labels", "label_lengths", "signal_lengths")


def batch_to_device(batch: Batch, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """{"signal", "labels", "label_lengths", "signal_lengths"} as tensors on
    device."""
    device = torch.device(device)
    out = {}
    for name in FIELDS:
        t = torch.from_numpy(getattr(batch, name))
        out[name] = (t.pin_memory().to(device, non_blocking=True)
                     if device.type == "cuda" else t.to(device))
    return out


def prefetch_to_device(it: Iterator[Batch], device: Union[str, torch.device],
                       size: int = 2):
    """Yield the batches of ``it`` on device, with ``size`` copies queued
    ahead of the one being consumed."""
    buf = collections.deque()
    it = iter(it)
    try:
        for _ in range(size):
            buf.append(batch_to_device(next(it), device))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(batch_to_device(next(it), device))
        except StopIteration:
            pass
        yield out
