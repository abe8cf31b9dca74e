"""utils/profiling.py against the JAX package's: the same FLOPs arithmetic,
MFU against the H100's peaks in place of the TPU's, the step timer, and a
torch.profiler trace on the CPU. The FLOPs are the same arithmetic, so they
must be equal; the MFU's ratio to JAX's is the ratio of the peaks, within
rtol 1e-12 (two float divisions)."""
import glob
import json
import math

import numpy as np
import pytest
import torch

from wavenet_speech_tpu.utils import profiling as jprofiling
from wavenet_speech_tpu_torch.utils import profiling

LAYER_LISTS = {
    "bench WaveNet": [(256, 256, 2, d) for d in [1, 2, 4, 8, 16, 32, 64, 128, 256, 512] * 3],
    "bench classifier": [(256, 256, 2, d) for d in [1, 2, 4, 8, 16, 32] * 3],
    "mixed widths": [(6, 10, 9, 7), (10, 32, 3, 1), (32, 32, 2, 4)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(LAYER_LISTS))
@pytest.mark.parametrize("train,remat", [(True, False), (True, True), (False, False),
                                         (False, True)])
def test_conv_stack_flops_equal_jax(name, train, remat):
    layers = LAYER_LISTS[name]
    for seq_len, batch in ((4505, 8), (100, 3)):
        got = profiling.conv_stack_flops(layers, seq_len, batch, train=train, remat=remat)
        assert got == jprofiling.conv_stack_flops(layers, seq_len, batch, train=train,
                                                  remat=remat)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mfu_is_jax_scaled_by_the_peaks(dtype):
    flops, secs = 1.234e15, 0.2495
    want = jprofiling.mfu(flops, secs, dtype) * (jprofiling.TPU_PEAK_TFLOPS[dtype]
                                                 / profiling.H100_PEAK_TFLOPS[dtype])
    assert math.isclose(profiling.mfu(flops, secs, dtype), want, rel_tol=1e-12)


def test_peaks_are_the_h100_data_sheet_values():
    """chip_smoke.py's bounds read these; PERF.md's bounds were computed
    with them."""
    assert profiling.H100_PEAK_TFLOPS == {"bf16": 989.0, "f32": 67.0}
    assert profiling.H100_TF32_PEAK_TFLOPS == 495.0
    assert profiling.H100_HBM_BYTES_PER_S == 3.35e12


def test_step_timer_records_and_gives_percentiles():
    timer = profiling.StepTimer()
    assert math.isnan(timer.mean) and math.isnan(timer.percentile(50))
    x = torch.ones(4)
    for _ in range(4):
        with timer.step(sync_value=x * 2):
            pass
    with timer.step():               # no readback
        pass
    with timer.step(sync_value=np.arange(3.0)):
        pass
    with timer.step() as s:          # a value the step computes
        s.sync_value = torch.full((2, 2), 3.0)
    assert len(timer.times) == 7 and all(t >= 0 for t in timer.times)
    assert timer.mean == pytest.approx(np.mean(timer.times))
    assert timer.percentile(50) == pytest.approx(np.percentile(timer.times, 50))
    assert timer.percentile(100) == max(timer.times)


def test_trace_writes_a_trace_naming_the_ops(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.mm(a, a).sum()
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert files == [prof.trace_path]
    names = {e.get("name") for e in json.loads(open(files[0]).read())["traceEvents"]}
    assert "aten::mm" in names and "aten::sum" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
