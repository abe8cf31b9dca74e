"""Fixtures of the benchmark's tests: a copy of the benchmark's files in a
temporary folder, with tiny cells that run on the CPU (the port's kernels'
plain versions) in seconds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
HARNESS = HERE.parent

TINY_CONFIGS = {
    "tiny_wavenet_ctc": {
        "family": "wavenet_ctc", "dtype": "float32", "init": {"kernel_variance": 1.0, "noise": 0.0},
        "model": {"base": {"signal_dim": 8, "entry_kwidth": 2, "kernel": 2,
                           "dilations": [1, 2, 4, 1, 2, 4], "out_dim": 8},
                  "classifier": {"in_dim": 8, "num_labels": 5, "kernel": 2,
                                 "dilations": [1, 2, 1, 2], "downsample": 4, "out_dim": 8}},
        "training": {"step": "joint", "optimizer": "adagrad", "learning_rate": 3e-2}},
    "tiny_raw_ctcnet": {
        "family": "raw_ctcnet", "dtype": "float32", "init": {"kernel_variance": 1.0, "noise": 1e-4},
        "model": {"num_features": 16, "feature_kwidth": 3, "num_labels": 5, "nhid": 8,
                  "kernels": [2, 3], "dilations": [1, 2], "cycles": 2, "out_dim": 8,
                  "input_kernel_size": 2},
        "training": {"step": "ctc", "preprocess": "batch_standardize", "optimizer": "adamax",
                     "learning_rate": 2e-3}},
}
TINY_TRAFFIC = {
    "tiny_train_levels": {"loop": "train", "generator": "uniform_levels", "batch": 4,
                          "length": 64, "levels": 8, "labels": 6, "bases": 4, "pool": 4,
                          "trace_steps": 1},
    "tiny_train_raw": {"loop": "train", "generator": "raw_gauss", "batch": 3, "bases_min": 15,
                       "bases_max": 18, "upsampling": 6, "upsampling_spread": 2, "pad_to": 63,
                       "labels_pad_to": 17, "pool": 4, "trace_steps": 1},
    "tiny_basecall": {"loop": "basecall", "generator": "onehot_reads", "batch": 3,
                      "length_min": 40, "length_max": 64, "levels": 8, "pool": 3,
                      "beam_width": 3, "bucket": 16, "check_reads": 5, "trace_calls": 2},
}
TINY_CELLS = {
    "tiny.train.wavenet_ctc": ("tiny_wavenet_ctc", "tiny_train_levels", "train.wavenet_ctc"),
    "tiny.train.raw_ctcnet": ("tiny_raw_ctcnet", "tiny_train_raw", "train.raw_ctcnet"),
    "tiny.basecall.wavenet_ctc": ("tiny_wavenet_ctc", "tiny_basecall", "basecall.wavenet_ctc"),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels and the cell's own size)")
    return torch.device("cuda")


def make_tiny_bench(tmp: Path):
    """A checkout-like folder: BENCHMARK.json with the real entries and the
    tiny cells (each on the limits of the real cell it shrinks), and the
    harness's data files. Returns a spec.Bench over it."""
    from h100_bench.spec import Bench

    root = tmp / "h100_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HARNESS / sub, root / sub)
    spec = json.loads((HARNESS.parent / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                "file": f"h100_bench/configs/{name}.json"})
    for name, mix in TINY_TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (cfg, mix, real) in TINY_CELLS.items():
        spec["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                  "why": "test"})
        shutil.copy(root / "limits" / f"{real}.json", root / "limits" / f"{name}.json")
        for kind in ("end_to_end", "per_layer"):
            for m in spec[kind]:
                if real in m.get("workloads", []):
                    m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp / "BENCHMARK.json", root)


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)
