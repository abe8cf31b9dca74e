"""Offline bisection of a dumped anomalous training step
(tools/bisect_nonfinite.py).

Loads a forensic dump written by the quality harness's skip-guard hook
(``examples/gaussian_eval.py`` through ``training.diagnostics.dump_anomaly``)
and re-runs the exact step section by section in bf16 and in float32
(``training.diagnostics.section_report``), printing the first non-finite
stage of each: where the overflow happens, and whether the precision
caused it.

Usage:
  python -m wavenet_speech_tpu_torch.tools.bisect_nonfinite \\
      --dump runs/<run>/anomalies/step_N_nonfinite --scale 1.0 --nhid 512 \\
      [--device cpu] [--out report.json]

--scale and --nhid must match the run that wrote the dump (the harness's
``build_model``). It runs on ``cuda`` unless --device names another device.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from wavenet_speech_tpu_torch.examples.gaussian_eval import build_model
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training.diagnostics import (first_nonfinite, load_anomaly,
                                                           section_report)
from wavenet_speech_tpu_torch.utils.device import resolve_device


def verdict(b16, f32) -> str:
    """JAX's four verdicts from the first non-finite site of each dtype."""
    if b16 and not f32:
        return (f"PRECISION-INDUCED: bf16 first goes non-finite at '{b16}'; the same step "
                f"is finite in f32")
    if b16 and f32:
        return f"NUMERIC DIVERGENCE (not precision): non-finite at '{b16}' (bf16) / '{f32}' (f32)"
    if not b16 and not f32:
        return ("NOT REPRODUCED offline: both dtypes finite — suspect the donated-buffer "
                "state or optimizer interaction, not the forward/backward math")
    return f"f32-only non-finite at '{f32}' (unexpected)"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m wavenet_speech_tpu_torch.tools.bisect_nonfinite")
    ap.add_argument("--dump", required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--nhid", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs it offline)")
    ap.add_argument("--out", default=None, help="write full reports here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(args.scale, nhid=args.nhid, device=dev)
    template = {k: v.detach() for k, v in model.state_dict().items()}
    batch, params = load_anomaly(args.dump, template)
    with open(os.path.join(args.dump, "meta.json")) as f:
        meta = json.load(f)
    print(f"dump: step {meta['step']} ({meta['note']}), recorded loss "
          f"{meta.get('ctc_loss')}, grad_norm {meta.get('grad_norm')}")

    reports = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        rep = section_report(model, params, batch, compute_dtype=dtype,
                             preprocess=batch_standardize)
        reports[name] = rep
        print(f"\n=== {name} ===  loss={rep['loss']:.6g}  first_nonfinite="
              f"{first_nonfinite(rep)}  probe==model.apply: {rep['probe_matches_model_apply']}")
        for stage, finite, mx in rep["stages"]:
            print(f"  {stage:<14} max|x| {mx:12.6g}{'' if finite else '   <-- NON-FINITE'}")
        for k, v in rep["grads"].items():
            print(f"  grad:{k:<12} max|g| {v['max_abs']:12.6g} sumsq_f32 "
                  f"{v['sumsq_f32']:12.6g}{'' if v['finite'] else '   <-- NON-FINITE'}")
        print(f"  global_norm sum-of-squares (f32): {rep['gnorm_sumsq_f32']:.6g}"
              + ("" if np.isfinite(rep["gnorm_sumsq_f32"]) else "   <-- OVERFLOWS f32"))

    out = {"meta": meta, "verdict": verdict(first_nonfinite(reports["bf16"]),
                                            first_nonfinite(reports["f32"])),
           "reports": reports}
    print(f"\nVERDICT: {out['verdict']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"full reports -> {args.out}")
    return out


if __name__ == "__main__":
    main()
