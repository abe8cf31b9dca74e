"""Profiling utilities (wavenet_speech_tpu/utils/profiling.py): a
``torch.profiler`` trace, the named spans the port marks its phases with, a
step timer that synchronises by reading a value back, a model-FLOPs
estimator of a conv stack, and MFU against the card's peaks.

The peaks are the NVIDIA H100 SXM data sheet's at a 700 W power limit, the
card the port's kernels are written for; this module is the port's one
source of them. A card set below 700 W runs slower under load, so an MFU is
reported beside the card's power limit.
"""
from __future__ import annotations

import contextlib
import os
import time
import types
from typing import Iterable

import numpy as np
import torch

# dense peak TFLOP/s by the dtype of a model's FLOPs: bf16 on the tensor
# cores; float32 outside them (the port runs float32 with TF32 off,
# utils/device.py, so 67 is the honest float32 peak)
H100_PEAK_TFLOPS = {"bf16": 989.0, "f32": 67.0}
H100_TF32_PEAK_TFLOPS = 495.0          # TF32 on the tensor cores, dense
H100_HBM_BYTES_PER_S = 3.35e12         # HBM3

_OFF = contextlib.nullcontext()


def span(name: str):
    """A region named ``name`` in a ``torch.profiler`` trace: while a
    profiler records, ``torch.profiler.record_function(name)``, whose host
    event lands on the trace's clock beside the CUDA kernels and copies;
    otherwise one shared no-op context. A ``record_function`` costs its
    enter and exit even with no profiler running; the check keeps the
    untraced path free of it. The region reads nothing back."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the region: CPU activity, and
    CUDA activity when a card is present. On exit the Chrome trace is
    written to ``<log_dir>/trace_<pid>_<ns>.json`` (viewable in Perfetto or
    chrome://tracing; its path is the profiler's ``trace_path``). Yields
    the profiler, whose ``key_averages()`` summarise the region."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


class StepTimer:
    """Times steps on the host clock. ``step(sync_value)`` reads one element
    of ``sync_value`` (a tensor or array) back before it stops the clock, so
    the work queued on the card is inside the time; with None it does not
    synchronise. A value the step itself computes is set on the object the
    context yields (``with timer.step() as s: ...; s.sync_value = loss``)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self, sync_value=None):
        box = types.SimpleNamespace(sync_value=sync_value)
        t0 = time.perf_counter()
        yield box
        if box.sync_value is not None:
            float(torch.as_tensor(box.sync_value).reshape(-1)[0])
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.times, q)) if self.times else float("nan")


def conv_stack_flops(layers: Iterable, seq_len: int, batch: int,
                     train: bool = True, remat: bool = False) -> float:
    """Approximate FLOPs of one step over a SkipSumStack layer list
    [(c_in, c_out, k, d)]: gate conv + fused 1x1 + residual + bottleneck.

    train=True multiplies by 3 (forward + backward): model FLOPs, which an
    MFU counts without recompute. remat=True adds one more forward, for a
    hardware-utilisation figure only (the port's stack does not remat)."""
    per_frame = 0.0
    for (c_in, c_out, k, _d) in layers:
        per_frame += 2 * (k * c_in * 2 * c_out    # fused gate conv
                          + c_out * 2 * c_out     # fused residual/skip 1x1
                          + c_in * c_out          # dense residual proj
                          + c_out * c_out)        # skip bottleneck (approx)
    total = per_frame * seq_len * batch
    if train:
        total *= 3
        if remat:
            total += per_frame * seq_len * batch
    return total


def mfu(flops_per_step: float, step_seconds: float, dtype: str = "bf16") -> float:
    """Model FLOPs utilisation against the H100's dense peak for ``dtype``
    ("bf16" or "f32"). Pass model FLOPs (3x the forward, no recompute)."""
    return flops_per_step / step_seconds / (H100_PEAK_TFLOPS[dtype] * 1e12)
