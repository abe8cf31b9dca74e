"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone are found by the harness and run; the modules of a
configuration's family and optimizer are found by name; a setting that no
module implements raises instead of being left out."""
from __future__ import annotations

import copy
import importlib.util
import json
import time

import pytest

from h100_bench.run import run_cell
from h100_bench.tests.conftest import TINY_CONFIGS, TINY_TRAFFIC


def test_added_files_are_found(tiny_bench):
    root, spec_path = tiny_bench.root, tiny_bench.spec_path
    cfg = dict(TINY_CONFIGS["tiny_wavenet_ctc"], init={"kernel_variance": 0.5, "noise": 0.0})
    (root / "configs" / "added_config.json").write_text(json.dumps(cfg))
    mix = dict(TINY_TRAFFIC["tiny_train_levels"], batch=2, length=40)
    (root / "traffic" / "added_mix.json").write_text(json.dumps(mix))
    (root / "limits" / "added.cell.json").write_text(
        (root / "limits" / "train.wavenet_ctc.json").read_text())
    (root / "metrics" / "added_steps.train.py").write_text(
        "def read(r):\n    return float(r.traced['steps'])\n")
    (root / "metrics" / "added_nothing.train.py").write_text("def read(r):\n    return None\n")
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "added_config", "source": "test", "reduced": [],
                            "why": "test", "file": "h100_bench/configs/added_config.json"})
    spec["workloads"].append({"name": "added.cell", "config": "added_config",
                              "traffic": "added_mix", "chips": 1, "why": "test"})
    spec["per_layer"] += [
        {"name": n, "unit": "1", "better": "higher", "source": "program_counter", "layer": "test",
         "moves": "train_samples_per_s", "workloads": ["added.cell"]}
        for n in ("added_steps.train", "added_nothing.train")]
    spec["end_to_end"][0]["workloads"].append("added.cell")
    spec_path.write_text(json.dumps(spec))

    from h100_bench.spec import Bench

    bench = Bench(spec_path, root)
    assert bench.config("added_config")["init"]["kernel_variance"] == 0.5
    assert bench.traffic("added_mix")["batch"] == 2
    assert [m["name"] for m in bench.per_layer("added.cell")] == \
        ["added_steps.train", "added_nothing.train"]
    traced = run_cell(bench, "added.cell", 3, 0.2, True, "cpu", time.perf_counter())
    assert traced["metrics"]["added_steps.train"]["value"] == mix["trace_steps"]
    assert "added_nothing.train" not in traced["metrics"]
    plain = run_cell(bench, "added.cell", 3, 0.2, False, "cpu", time.perf_counter())
    assert set(plain["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert plain["correct"] and list(plain)[-1] == "checks"


def _module(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


def test_benchmark_json_names_files_that_exist():
    from h100_bench.spec import Bench

    bench = Bench()
    for c in bench.spec["configs"]:
        cfg = bench.config(c["name"])
        for pkg in ("port", "reference", "counts"):
            assert _module(f"h100_bench.{pkg}.{cfg['family']}"), (c["name"], pkg)
        assert _module(f"h100_bench.reference.optim.{cfg['training']['optimizer']}")
    for w in bench.spec["workloads"]:
        assert _module(f"h100_bench.loops.{bench.traffic(w['traffic'])['loop']}")
        assert bench.limits(w["name"])
        assert any(m["name"] != "setup_s" for m in bench.end_to_end(w["name"]))
        for m in bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))
            assert m["moves"] in [e["name"] for e in bench.end_to_end(w["name"])]


def _broken(cfg, path, value):
    cfg = copy.deepcopy(cfg)
    *head, last = path
    node = cfg
    for k in head:
        node = node[k]
    node[last] = value
    return cfg


@pytest.mark.parametrize("name,path,value", [
    ("tiny_wavenet_ctc", ("dtype",), "float16"),
    ("tiny_wavenet_ctc", ("training", "step"), "ctc"),
    ("tiny_wavenet_ctc", ("training", "max_grad_norm"), 1.0),
    ("tiny_wavenet_ctc", ("model", "base", "causal"), False),
    ("tiny_raw_ctcnet", ("dtype",), "bfloat16"),
    ("tiny_raw_ctcnet", ("training", "preprocess"), "none"),
    ("tiny_raw_ctcnet", ("model", "positions"), True),
    ("tiny_raw_ctcnet", ("precision",), "tf32")])
def test_unimplemented_settings_raise(tmp_path, name, path, value):
    """Every key of a configuration is read: a value or a key that neither
    the port's adapter nor the reference implements stops the run."""
    from h100_bench.tests.conftest import make_tiny_bench

    bench = make_tiny_bench(tmp_path)
    cfg_path = bench.root / "configs" / f"{name}.json"
    cfg_path.write_text(json.dumps(_broken(TINY_CONFIGS[name], path, value)))
    cell = "tiny.train.wavenet_ctc" if "wavenet" in name else "tiny.train.raw_ctcnet"
    with pytest.raises(ValueError):
        run_cell(bench, cell, 1, 0.1, False, "cpu", time.perf_counter())


def test_bfloat16_trains_in_bfloat16(tmp_path):
    """A bfloat16 configuration runs the port's mixed precision: its first
    loss departs from the float32 reference by bfloat16's rounding, where
    the float32 program's agrees to float32's."""
    from h100_bench.tests.conftest import make_tiny_bench

    bench = make_tiny_bench(tmp_path)
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dict(TINY_CONFIGS["tiny_wavenet_ctc"], dtype=dtype)
        (bench.root / "configs" / "tiny_wavenet_ctc.json").write_text(json.dumps(cfg))
        out = run_cell(bench, "tiny.train.wavenet_ctc", 5, 0.1, False, "cpu", time.perf_counter())
        gaps[dtype] = out["checks"]["loss_gap"]["value"]
    assert gaps["float32"] < 1e-6 < 1e-4 < gaps["bfloat16"] < 0.1, gaps
