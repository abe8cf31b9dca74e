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
    """mfu reads the float32 and bf16 peaks; PERF.md's bounds were
    computed with all three."""
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


# ---- the port's spans (utils.profiling.span) -------------------------------------

from wavenet_speech_tpu_torch.facade import Model  # noqa: E402
from wavenet_speech_tpu_torch.inference import Basecaller  # noqa: E402
from wavenet_speech_tpu_torch.ops.norm import batch_standardize  # noqa: E402
from wavenet_speech_tpu_torch.training import (TrainState, build_optimizer,  # noqa: E402
                                               make_joint_train_step, param_tree)
from wavenet_speech_tpu_torch.training.trainer import make_ctc_train_step  # noqa: E402
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

LEVELS, LABELS = 8, 5
TRAIN_SPANS = ["train.forward", "train.backward", "train.guard", "train.update"]
BASECALL_SPANS = ["basecall.bucket", "basecall.to_device", "basecall.forward",
                  "basecall.decode", "basecall.strings"]
SPANS = {"joint": TRAIN_SPANS + ["train.update_state"], "ctc": TRAIN_SPANS,
         "basecall_beam": BASECALL_SPANS, "basecall_greedy": BASECALL_SPANS}


def _wavenet_ctc():
    cfg = {"model": {"base": {"signal_dim": LEVELS, "dilations": [1, 2, 4]},
                     "classifier": {"num_labels": LABELS, "dilations": [1, 2],
                                    "downsample": 4}}}
    return Model("wavenet-ctc", cfg, device="cpu").init(0)


def _train_batch(onehot: bool):
    rng = np.random.default_rng(3)
    B, L, S = 2, 48, 5
    lv = rng.integers(0, LEVELS, size=(B, L))
    signal = np.eye(LEVELS, dtype=np.float32)[lv] if onehot \
        else (rng.standard_normal((B, L, 1)) * 8 + 80).astype(np.float32)
    return {"signal": signal, "labels": rng.integers(1, LABELS, size=(B, S)).astype(np.int32),
            "label_lengths": np.array([S, S - 2], np.int32),
            "signal_lengths": np.array([L, L - 6], np.int32)}


def _case(name):
    """run() for the case: one train step from the same fresh state each
    time, returning its params, optimizer state, step and metrics; or one
    Basecaller call, returning its strings and scores."""
    if name in ("joint", "ctc"):
        if name == "joint":
            m = _wavenet_ctc()
            tx = build_optimizer("adagrad", 1e-2)
            step = make_joint_train_step(m.model_base, m.model_ctc, tx)
            params = param_tree(m.model_base, m.model_ctc)
        else:
            cfg = {"model": {"type": "raw-ctcnet",
                             "raw": {"num_features": 12, "feature_kwidth": 3,
                                     "num_labels": LABELS, "num_dilation_blocks": 1,
                                     "kernel": 3, "dilations": [1, 2], "out_dim": 12}}}
            net = Model("raw-ctcnet", cfg, device="cpu").init(0).model_ctc
            tx = build_optimizer("adamax", 1e-3)
            step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
            params = net.state_dict()
        batch = _train_batch(onehot=name == "joint")

        def run():
            state, metrics = step(TrainState.create(tree_map(torch.clone, params), tx), batch)
            return tree_leaves(state.params) + tree_leaves(state.opt_state) + \
                [state.step] + [metrics[k] for k in sorted(metrics)]
        return run
    caller = Basecaller(_wavenet_ctc(), beam_width=3 if name == "basecall_beam" else 0,
                        pad_to_multiple=64, device="cpu")
    signal = np.eye(LEVELS, dtype=np.float32)[
        np.random.default_rng(4).integers(0, LEVELS, size=(3, 90))]
    return lambda: caller(signal, lengths=np.array([90, 77, 60]))


def _profiled(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    names = set().union(*SPANS.values())
    spans = sorted((e for e in prof.events() if e.name in names), key=lambda e: e.time_range.start)
    return out, [e.name for e in spans]


@pytest.mark.parametrize("case", sorted(SPANS))
def test_spans_once_each_in_order_under_a_profiler(case):
    _, spans = _profiled(_case(case))
    assert spans == SPANS[case]


@pytest.mark.parametrize("case", sorted(SPANS))
def test_no_record_function_without_a_profiler(case, monkeypatch):
    """Off the profiler span() hands out one shared no-op context and never
    reaches record_function, which here raises."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    _case(case)()


@pytest.mark.parametrize("case", sorted(SPANS))
def test_results_bit_equal_with_and_without_a_profiler(case):
    """The spans read nothing back and change no arithmetic: a step's
    params, optimizer state and metrics, and a call's strings and scores,
    are the same bits under an active profiler."""
    run = _case(case)
    plain = run()
    traced, _ = _profiled(run)
    if case.startswith("basecall"):
        assert traced == plain
        return
    assert len(traced) == len(plain)
    for a, b in zip(traced, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
