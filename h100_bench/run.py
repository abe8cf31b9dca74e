"""Run one cell of the benchmark once, on the machine it is started on:

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up makes the weights on the card and the
traffic from the seed, builds the port's model, and warms every shape the
cell uses (the first steps of a train cell are the ones the check
compares). The window then runs for ``--seconds``. With ``--trace 1`` a
short steady part after the window is traced and the per-layer metrics are
reported; without it, the end-to-end ones. Once the window has closed and
the program's state is freed, the reference checks what the timed path
produced (``compare.py``), and the numbers compared are printed beside
their limits, last on standard error and last in the result.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (breakdown,) setup_parts (the seconds of set-up
spent compiling the port's kernels, which only a checkout's first run
does), checks. It exits non-zero, with no
result, when no CUDA device is present, when the port is not the one in
this checkout, or when JAX or the JAX package has been loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wavenet_speech_tpu")
ROOT = Path(__file__).resolve().parent.parent


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def count_builds() -> List[float]:
    """The seconds the port spends compiling its kernels in this process,
    one entry a build call (``ops._build.build`` returns them: 0 for a
    library already in the checkout's cache). ``setup_s`` holds them, as
    the set-up of a run that compiles does; they are also reported apart."""
    from wavenet_speech_tpu_torch.ops import _build

    seconds: List[float] = []
    build = _build.build

    def counted(*args, **kw):
        out = build(*args, **kw)
        seconds.append(sum(out.values()))
        return out

    _build.build = counted
    return seconds


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """One run of a cell on device. Returns the result object."""
    import torch

    from h100_bench import loops
    from h100_bench.compare import judge
    from h100_bench.counts.peaks import lookup
    from h100_bench.readings import Readings
    from h100_bench.trace import capture

    device = torch.device(device)
    cell = bench.cell(name)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    loop = loops.get(mix["loop"])(cfg, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    win = loop.window(seconds)
    traced = tr = None
    if trace:
        tr, traced = capture(loop, device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if device.type == "cuda" else 0}
    loop.release()
    numbers = loop.check()
    correct = judge(numbers, limits)

    metrics = {}
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        r = Readings(cell=cell, cfg=cfg, mix=mix, window=win, trace=tr, traced=traced,
                     peaks=lookup(kind))
        for m in bench.per_layer(name):
            v = bench.reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": limits.get(k)}
                     for k, v in numbers.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100_bench.spec import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"h100_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import wavenet_speech_tpu_torch

    port = Path(wavenet_speech_tpu_torch.__file__).resolve()
    if ROOT not in port.parents:
        print(f"h100_bench: the port imported from {port} is not this checkout's ({ROOT})",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    builds = count_builds()
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START)
    checks = out.pop("checks")
    out["setup_parts"] = {"kernel_build_s": sum(builds)}
    out["checks"] = checks
    print(f"setup: kernel build {sum(builds)} s (within setup_s)", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
