"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have, and a sound run comes out correct; all on
the CPU at a tiny size, held to the real cells' limits. Also: the command
prints no result and exits non-zero without a CUDA device."""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from h100_bench.faults import planted
from h100_bench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train.wavenet_ctc", None), ("tiny.train.wavenet_ctc", "unchanged"),
    ("tiny.train.wavenet_ctc", "half"), ("tiny.train.raw_ctcnet", None),
    ("tiny.train.raw_ctcnet", "unchanged"), ("tiny.train.raw_ctcnet", "half"),
    ("tiny.basecall.wavenet_ctc", None), ("tiny.basecall.wavenet_ctc", "alter")])
def test_fault_is_not_correct(tiny_bench, cell, fault):
    family = tiny_bench.config(tiny_bench.cell(cell)["config"])["family"]
    with planted(fault, family) if fault else contextlib.nullcontext():
        out = run_cell(tiny_bench, cell, 2 ** 31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def _run(cwd: Path):
    return subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                           "train.wavenet_ctc", "--seed", "1", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
