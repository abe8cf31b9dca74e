"""The benchmark's registry: ``BENCHMARK.json`` and the files it names,
found by name. A cell is a ``workloads`` entry; its configuration is the
file the ``configs`` entry names (relative to BENCHMARK.json), its traffic
``traffic/<traffic>.json``, its limits ``limits/<cell>.json``, and each
per-layer metric is read by ``metrics/<metric>.py``, all under the
harness's folder. Adding a cell, a configuration, a mix or a metric adds
files and entries and edits none."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
# the keys of a configuration's file: the family names the modules that read
# "model" and "training" (port/, reference/, counts/ <family>.py), weights.py
# reads "init", the readers "dtype"; "source", "reduced" and "assumed" are notes
CONFIG_KEYS = {k: None for k in ("family", "source", "reduced", "assumed", "dtype", "model",
                                 "init", "training")}


class Bench:
    def __init__(self, spec_path: Path = HERE.parent / "BENCHMARK.json", root: Path = HERE):
        self.spec_path, self.root = Path(spec_path), Path(root)
        self.spec = json.loads(self.spec_path.read_text())

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.spec_path}")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.spec_path.parent / c["file"]).read_text())
                return settings(cfg, CONFIG_KEYS, c["file"])
        raise KeyError(f"no config {name!r} in {self.spec_path}")

    def _json(self, *parts) -> Dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", f"{cell}.json")

    def _metrics(self, kind: str, cell: str) -> List[Dict]:
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def end_to_end(self, cell: str) -> List[Dict]:
        return self._metrics("end_to_end", cell)

    def per_layer(self, cell: str) -> List[Dict]:
        return self._metrics("per_layer", cell)

    def reader(self, metric: str):
        """The read(readings) function of metrics/<metric>.py."""
        path = self.root / "metrics" / f"{metric}.py"
        name = "h100_bench_metric_" + metric.replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def settings(section: Dict, allowed: Dict, where: str) -> Dict:
    """section, whose every key is one of allowed's and whose every value is
    one that allowed lists for its key (None: any value). A key or a value
    that the reader does not implement raises, so that a configuration
    never asks for something that is silently not done."""
    for key, value in section.items():
        if key not in allowed:
            raise ValueError(f"{where}: no support for the key {key!r}")
        if allowed[key] is not None and value not in allowed[key]:
            raise ValueError(f"{where}: {key} = {value!r} is not implemented "
                             f"(implemented: {sorted(allowed[key])})")
    return section
