"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the chip at the cell's own size, many seeds in one process:

    python3 -m h100_bench.calibrate --workload <cell> --mode <mode> --seeds 1,2,3

Modes: ``program`` (sound runs: the lower readings), ``control`` (the
reference put in the program's place, in the precision below the
configuration's float32: TF32 in the matrix products, and for a
basecall's beam, which has none, bfloat16 log-probabilities: the upper
readings), and the faults of ``faults.py`` planted in the program's timed
path (``unchanged``, ``half``, ``alter``). A train cell's readings need no
window: its first three steps are what is compared. A basecall cell
answers each batch of its pool once. Prints one JSON line a seed, with
the numbers compared and, beside them, diagnostics compared with nothing
(the worst leaf without the median floor; the spread of the score gaps)."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from h100_bench import faults, gen, loops
from h100_bench.compare import (ALPHABET, basecall_numbers, score_gaps, train_detail,
                                train_numbers)
from h100_bench.reference.beam import log_softmax64, prefix_beam
from h100_bench.spec import Bench

LETTERS = {v: k for k, v in ALPHABET.items()}
CONTROLS = ("float32",)  # the dtypes whose control is written here: TF32, a bfloat16 beam


def bf16(x):
    """x rounded to bfloat16: the beam's control precision (float32's next
    below outside the matrix products)."""
    return torch.as_tensor(x).to(torch.bfloat16).double().numpy()


def _scores(answers, best) -> dict:
    gaps = score_gaps(answers, best)
    if not gaps:
        return {}
    q = np.percentile(gaps, [50, 75, 90, 95, 100])
    return {"score_gap_p%d" % p: float(v) for p, v in zip((50, 75, 90, 95, 100), q)}


def _control(loop, mix) -> tuple:
    if loop.cfg["dtype"] not in CONTROLS:
        raise ValueError(f"no control written for dtype {loop.cfg['dtype']!r}")
    loop.pool = gen.make(mix, loop.seed)
    if mix["loop"] == "train":
        ctrl, ref = loop.reference(tf32=True), loop.reference()
        return train_numbers(ctrl, ref), train_detail(ctrl, ref)
    loop.answers = [(k, None) for k in range(len(loop.pool))]
    picked = loop.sample()
    ctrl, ref = loop.reference_logits(picked, tf32=True), loop.reference_logits(picked)
    W = mix["beam_width"]
    rows = [(ctrl[(k, r)], ref[(k, r)]) for k, r, _ in picked]
    served = [prefix_beam(bf16(log_softmax64(c)), W)[0] for c, _ in rows]
    answers = [("".join(LETTERS[c] for c in b[0]), b[1]) for b in served]
    best = [prefix_beam(log_softmax64(c), W)[0] for c, _ in rows]
    return basecall_numbers(rows, answers, best), _scores(answers, best)


def readings(bench, cell: str, seed: int, mode: str, device) -> tuple:
    """(the numbers compared, diagnostics) of one seed in one mode."""
    cfg, mix = bench.config(bench.cell(cell)["config"]), bench.traffic(bench.cell(cell)["traffic"])
    loop = loops.get(mix["loop"])(cfg, mix, seed, torch.device(device))
    if mode == "control":
        return _control(loop, mix)
    fault = contextlib.nullcontext() if mode == "program" else \
        faults.planted(mode, cfg["family"])
    with fault:
        loop.setup()
        if mix["loop"] == "basecall":
            loop.answers = [(k, loop.call(k)) for k in range(len(loop.pool))]
    loop.release()
    numbers = loop.check()
    if mix["loop"] == "train":
        return numbers, train_detail(loop.prog, loop.ref_readings)
    return numbers, _scores(loop.checked["answers"], loop.checked["best"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, choices=("program", "control", *faults.FAULTS))
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100_bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    for s in args.seeds.split(","):
        t = time.perf_counter()
        numbers, detail = readings(bench, args.workload, int(s), args.mode, "cuda")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": int(s),
                          "seconds": time.perf_counter() - t,
                          "numbers": {k: float(v) for k, v in numbers.items()},
                          "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
