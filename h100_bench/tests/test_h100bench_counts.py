"""The FLOP and byte counts against hand counts at one small shape, and
the readers' arithmetic on a synthetic trace."""
from __future__ import annotations

import pytest

from h100_bench.counts import kernels, model
from h100_bench.readings import Readings, fused_roofline, idle_share, mfu
from h100_bench.trace import Trace

TINY = {"family": "wavenet_ctc", "dtype": "float32",
        "model": {"base": {"signal_dim": 2, "entry_kwidth": 2, "kernel": 2, "dilations": [1],
                           "out_dim": 2},
                  "classifier": {"in_dim": 2, "num_labels": 3, "kernel": 2, "dilations": [1],
                                 "downsample": 2, "out_dim": 2}}}
RAW = {"family": "raw_ctcnet", "dtype": "float32",
       "model": {"num_features": 4, "feature_kwidth": 3, "num_labels": 5, "nhid": 2,
                 "kernels": [2], "dilations": [1], "cycles": 1, "out_dim": 2,
                 "input_kernel_size": 2}}


def test_fused_block_counts_by_hand():
    # rows 10, c_in 4, c 3, k 2: MACs a row 2*4*6 + 3*6 + 4*3 = 78
    assert kernels.fused_block_fwd(10, 4, 3, 2) == (2.0 * 10 * 78, 4.0 * (10 * 10 + 93))
    # backward: dx and dW of each product; reads x, dresid, dskip, W; writes dx, dW
    assert kernels.fused_block_bwd(10, 4, 3, 2) == (4.0 * 10 * 78, 4.0 * (10 * 14 + 186))
    assert kernels.least_seconds(10.0, 8.0, 5.0, 2.0) == 4.0
    assert kernels.least_seconds(10.0, 2.0, 5.0, 2.0) == 2.0


def test_model_flops_by_hand():
    # base a sample: entry 2*2*2*2 + block 2*(2*2*4 + 2*4 + 2*2 + 2*2) + out 2*2*(2*2)
    # head a pooled frame: input block 64 + block 64 + out 2*(2*2 + 2*3)
    assert model.forward_flops(TINY, [8]) == 96 * 8 + 148 * 4
    assert model.forward_flops(TINY, [8, 9]) == 96 * 17 + 148 * 8
    # raw a frame: featurizer 2*3*4 + 2*4*4, input block 2*(2*4*4 + 2*4 + 4*2 + 2*2),
    # one block 2*(2*2*4 + 2*4 + 2*2 + 2*2), out 2*(2*2 + 2*5); L + 2 frames
    assert model.forward_flops(RAW, [10]) == (56 + 104 + 64 + 28) * 12


def _events():
    def k(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}

    return [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::pad", "ts": 0, "dur": 20},
        k("split_planes_kernel", 20, 2), k("fused_gated_block_kernel<2, false>", 22, 18),
        k("split_planes_kernel", 40, 2), k("bwd_rows_kernel<false>", 42, 8),
        k("bwd_wgrad_kernel", 50, 10), k("sm80_xmma_gemm_f32", 70, 10),
    ]


def test_trace_reading():
    t = Trace(_events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)
    assert t.busy_within(0, 60) == pytest.approx(40e-6)
    fwd = t.kernel_seconds(r"fused_gated_block_kernel", prep=r"split_planes_kernel",
                           owners=r"fused_gated_block_kernel|bwd_rows_kernel")
    bwd = t.kernel_seconds(r"bwd_rows_kernel|bwd_wgrad_kernel", prep=r"split_planes_kernel",
                           owners=r"fused_gated_block_kernel|bwd_rows_kernel")
    assert fwd == pytest.approx(20e-6) and bwd == pytest.approx(20e-6)
    assert t.top_ops(2)[0] == ["fused_gated_block_kernel<2, false>", pytest.approx(18e-6)]
    gaps = t.idle_gaps(10)
    assert gaps[0] == ["bench.call / aten::pad", pytest.approx(20e-6)]
    assert sum(g for _, g in gaps) == pytest.approx(50e-6)


def test_readers_arithmetic():
    peaks = {"flops": {"float32": 1e6}, "bytes_per_s": 1e6}
    r = Readings(cell={}, cfg=TINY, mix={}, window={"seconds": 2.0, "flops": 1e6},
                 trace=Trace(_events()), traced={"rows": 10}, peaks=peaks)
    assert mfu(r) == pytest.approx(50.0)
    assert idle_share(r) == pytest.approx(50.0)
    flops, nbytes = kernels.fused_block_fwd(10, 2, 2, 2)
    want = 100.0 * max(flops / 1e6, nbytes / 1e6) / 20e-6
    assert fused_roofline(r, kernels.fused_block_fwd, r"fused_gated_block_kernel") == \
        pytest.approx(want)
    off_chip = Readings(cell={}, cfg=TINY, mix={}, window={"seconds": 2.0, "flops": 1e6},
                        trace=None, traced={}, peaks=None)
    assert mfu(off_chip) is None and idle_share(off_chip) is None
