"""What a per-layer reader is handed (``metrics/<name>.py`` defines
``read(r: Readings) -> float | None``), and the arithmetic the readers
share. A reader that finds nothing to read returns None, and the run
leaves its metric out."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from h100_bench.counts import kernels
from h100_bench.counts.model import causal_layers
from h100_bench.trace import Trace

# the port's own kernels (csrc/*.cu), by the names the device trace gives
FUSED_FWD = r"fused_gated_block_kernel"
FUSED_BWD = r"bwd_rows_kernel|bwd_wgrad_kernel|bwd_slice_sum_kernel"
FUSED_PREP = r"split_planes_kernel"
OWN = r"fused_gated_block|bwd_rows_kernel|bwd_wgrad_kernel|bwd_slice_sum|split_planes|" \
      r"ctc_alpha|ctc_beta|ctc_beam"
# cuDNN's convolutions and cuBLAS's matrix products
LIBRARY = r"gemm|conv|cudnn|xmma|cutlass|cublas|implicit|winograd|fprop|dgrad|wgrad|gemv"


@dataclasses.dataclass
class Readings:
    cell: Dict
    cfg: Dict
    mix: Dict
    window: Dict                  # the loop's window: seconds, flops, ...
    trace: Optional[Trace]        # None in a run without --trace 1
    traced: Dict                  # what the traced part ran: steps or calls, rows
    peaks: Optional[Dict]         # counts.peaks.lookup of the device, None off the chip


def mfu(r: Readings) -> Optional[float]:
    """Model FLOPs of the window over its seconds and the peak, in %."""
    if r.peaks is None or not r.window.get("flops"):
        return None
    return 100.0 * r.window["flops"] / r.window["seconds"] / r.peaks["flops"][r.cfg["dtype"]]


def idle_share(r: Readings) -> Optional[float]:
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def fused_roofline(r: Readings, counts, pattern: str) -> Optional[float]:
    """The fused block's least time over the traced rows, over its device
    time, in %."""
    layers = causal_layers(r.cfg)
    if r.trace is None or r.peaks is None or not layers:
        return None
    seconds = r.trace.kernel_seconds(pattern, prep=FUSED_PREP,
                                     owners=f"{FUSED_FWD}|bwd_rows_kernel")
    if seconds <= 0:
        return None
    peak = r.peaks["flops"][r.cfg["dtype"]]
    least = sum(kernels.least_seconds(*counts(r.traced["rows"], ci, co, k), peak,
                                      r.peaks["bytes_per_s"]) for ci, co, k, _ in layers)
    return 100.0 * least / seconds
