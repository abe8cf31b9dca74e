"""device_ops.train on a synthetic trace: the device operations of the
traced window over its steps; nothing without a trace."""
from __future__ import annotations

import pytest

from h100_bench.readings import Readings
from h100_bench.spec import Bench
from h100_bench.trace import Trace


def _events():
    def op(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    return [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        op("kernel", "fused_gated_block_kernel<2, false>", 10, 20),
        op("kernel", "multi_tensor_apply<AdamaxOp>", 40, 5),
        op("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 35, 1),
        op("gpu_memset", "Memset (Device)", 50, 1),
        op("kernel", "after_the_window", 120, 5),        # outside: not counted
        op("cpu_op", "aten::add", 0, 30),                # host: not counted
        op("cuda_runtime", "cudaLaunchKernel", 5, 2),
    ]


def test_device_ops_counts_the_window_per_step():
    read = Bench().reader("device_ops.train")
    r = Readings(cell={}, cfg={}, mix={}, window={}, trace=Trace(_events()),
                 traced={"steps": 2}, peaks=None)
    assert read(r) == pytest.approx(2.0)


def test_device_ops_without_a_trace_is_none():
    read = Bench().reader("device_ops.train")
    off = Readings(cell={}, cfg={}, mix={}, window={}, trace=None, traced={}, peaks=None)
    assert read(off) is None
