"""Nothing the harness runs loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HARNESS = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "wavenet_speech_tpu"}
# modules that must not reach the port: the reference and the yardstick
PORT_FREE = sorted(
    ".".join(p.relative_to(HARNESS.parent).with_suffix("").parts).replace(".__init__", "")
    for pattern in ("reference/**/*.py", "counts/*.py", "gen.py", "weights.py", "compare.py",
                    "trace.py", "spec.py", "readings.py")
    for p in HARNESS.glob(pattern))


def _imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in HARNESS.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imported_names(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_sources_import_nothing_of_the_port():
    assert "h100_bench.reference.optim.adamax" in PORT_FREE
    for mod in PORT_FREE:
        path = HARNESS.parent / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = HARNESS.parent / mod.replace(".", "/") / "__init__.py"
        tops = {name.split(".")[0] for name in _imported_names(path)}
        assert "wavenet_speech_tpu_torch" not in tops, path


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=HARNESS.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    loaded = _loaded_after(
        "import time, tempfile, pathlib\n"
        "from h100_bench.tests.conftest import make_tiny_bench\n"
        "from h100_bench.run import run_cell, forbidden_modules\n"
        "b = make_tiny_bench(pathlib.Path(tempfile.mkdtemp()))\n"
        "for cell in ('tiny.train.raw_ctcnet', 'tiny.basecall.wavenet_ctc'):\n"
        "    run_cell(b, cell, 1, 0.1, True, 'cpu', time.perf_counter())\n"
        "assert not forbidden_modules()\n"
        "import h100_bench.calibrate")
    assert "wavenet_speech_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("\n".join(f"import {m}" for m in PORT_FREE))
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"wavenet_speech_tpu_torch"})
