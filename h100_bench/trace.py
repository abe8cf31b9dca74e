"""The device trace of a short steady part of a run: ``torch.profiler``
over the loop's ``traced`` part (CPU and CUDA activity), exported as a
Chrome trace under the run's temporary directory, read, and deleted.

``Trace`` keeps what the per-layer readers need: the traced window (the
``bench.window`` span), the device's operations in it (kernels, copies,
sets), the benchmark's own spans (``bench.*``) and the host's operations,
from which it works out the busy time, the idle gaps and what the host
was doing in each."""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")

Event = Tuple[str, float, float]  # name, start us, end us


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "bench.window"]
        if not win:
            raise RuntimeError("the trace holds no bench.window span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device: List[Event] = []
        self.spans: List[Event] = []
        self.host: List[Event] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            cat, name = e.get("cat"), e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((name, a, b))
            elif cat == "user_annotation" and name.startswith("bench.") \
                    and name != "bench.window":
                self.spans.append((name, a, b))
            elif cat in HOST_CATS:
                self.host.append((name, a, b))
        self.device.sort(key=lambda x: x[1])
        self.busy = _merge([(a, b) for _, a, b in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def busy_within(self, a: float, b: float) -> float:
        """Seconds of [a, b) (us) in which the device ran something."""
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in self.busy) * 1e-6

    def kernel_seconds(self, pattern: str, prep: Optional[str] = None,
                       owners: Optional[str] = None, exclude: Optional[str] = None) -> float:
        """Device seconds of the kernels whose names match pattern (and not
        exclude). A kernel matching prep counts where the next kernel
        matching owners after it matches pattern: the preparation launched
        for it."""
        pat = re.compile(pattern)
        exc = re.compile(exclude) if exclude else None
        total = 0.0
        kernels = self.device
        for i, (name, a, b) in enumerate(kernels):
            if pat.search(name) and not (exc and exc.search(name)):
                total += b - a
            elif prep and re.search(prep, name):
                for later, _, _ in kernels[i + 1:]:
                    if re.search(owners, later):
                        if pat.search(later):
                            total += b - a
                        break
        return total * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        """The n device operations that took most time, summed by name."""
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def _doing(self, a: float, b: float) -> str:
        """What the host was doing in [a, b): the benchmark span around it
        and the host operation that overlaps it most."""
        mid = 0.5 * (a + b)
        around = [s for s in self.spans if s[1] <= mid < s[2]]
        span = min(around, key=lambda s: s[2] - s[1])[0] if around else "bench.window"
        best, name = 0.0, "python"
        for op, x, y in self.host:
            ov = min(b, y) - max(a, x)
            if ov > best:
                best, name = ov, op
        return f"{span} / {name}"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest idle gaps, each named by what the host was doing."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self._doing(a, b), (b - a) * 1e-6] for a, b in longest]


def capture(loop, device) -> Tuple[Trace, Dict]:
    """Trace the loop's ``traced`` part. Returns (trace, what the loop
    says it ran)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    tmp = tempfile.mkdtemp(prefix="h100_bench_trace_")
    try:
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                info = loop.traced(record_function)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events), info
