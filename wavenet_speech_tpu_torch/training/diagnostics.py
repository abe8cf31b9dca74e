"""Anomaly forensics for long training runs: capture and bisect non-finite
steps (wavenet_speech_tpu/training/diagnostics.py).

  * dump_anomaly: save the exact (batch, params) pair at the moment the
    train step's skip guard fires. The guard carries the params through a
    skipped step unchanged, so the dump reproduces the step.
  * section_report: re-run one RawCTCNet train step section by section
    (featurizer -> input block -> the residual stack -> output head -> CTC)
    and its backward per top-level parameter group, recording finiteness
    and max|x| at every stage, in a compute dtype. The bf16 report against
    the float32 one on the same dump names the first tensor that goes
    non-finite, and whether the precision caused it.
  * first_nonfinite: the first stage whose stats are non-finite.

The report's stages and keys are JAX's, so the two compare key for key.
The stack's stages follow JAX's rule for its ``lax.scan`` path
(models/stack.py:89-93): a schedule whose cycle repeats at least twice is
reported per cycle (``cycles_out``/``cycles_skips``), another per block
(``blocks_out``/``blocks_skips``). The port runs every stack unrolled and
takes the per-cycle maxima at the same points.

Offline tool: ``python -m wavenet_speech_tpu_torch.tools.bisect_nonfinite``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from wavenet_speech_tpu_torch.data.prefetch import FIELDS
from wavenet_speech_tpu_torch.ops.activations import hardtanh, leaky_relu
from wavenet_speech_tpu_torch.ops.conv import _conv1d
from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_per_seq
from wavenet_speech_tpu_torch.training.checkpoint import restore_params, save_params
from wavenet_speech_tpu_torch.training.trainer import _cast

PARAMS_FILE = "params.pt"   # inside the dump's params/ directory
MIN_SCAN_REPEATS = 2        # JAX SkipSumStack.min_scan_repeats


# --------------------------------------------------------------------------
# dump


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def dump_anomaly(dump_dir: str, batch, params, step: int, note: str,
                 extra: Optional[Dict[str, Any]] = None,
                 max_dumps: int = 3) -> Optional[str]:
    """Persist the forensic kit for one anomalous step.

    batch: a host ``Batch`` or a dict with its fields (arrays or tensors).
    params: the model's params {name: tensor} (not the optimizer state: the
    bisect needs only the forward and backward).

    Layout: <dump_dir>/step_<step>_<note>/{batch.npz, params/, meta.json}.
    Returns the dump path, or None if it already exists (a re-run of the
    same failing step) or max_dumps is reached."""
    os.makedirs(dump_dir, exist_ok=True)
    existing = [d for d in os.listdir(dump_dir) if d.startswith("step_")]
    path = os.path.join(dump_dir, f"step_{int(step)}_{note}")
    if os.path.isdir(path) or len(existing) >= max_dumps:
        return None
    os.makedirs(os.path.join(path, "params"))
    fields = batch if isinstance(batch, dict) else {k: getattr(batch, k) for k in FIELDS}
    np.savez(os.path.join(path, "batch.npz"), **{k: _host(v) for k, v in fields.items()})
    save_params(os.path.join(path, "params", PARAMS_FILE), params)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step), "note": note,
                   **{k: float(v) for k, v in (extra or {}).items()}}, f)
    return path


def load_anomaly(path: str, params_like):
    """Inverse of dump_anomaly: (batch dict of numpy arrays, params checked
    against params_like and placed on its devices)."""
    with np.load(os.path.join(path, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    return batch, restore_params(os.path.join(path, "params", PARAMS_FILE), params_like)


# --------------------------------------------------------------------------
# section-wise report


def detect_cycle(layers: Sequence) -> int:
    """Smallest cycle length c with layers[i] == layers[i % c]; len(layers)
    if there is none shorter (JAX models/stack.py:27-35)."""
    n = len(layers)
    for c in range(1, n):
        if n % c == 0 and all(layers[i] == layers[i % c] for i in range(n)):
            return c
    return n


def scan_config(layers: Sequence):
    """(cycle length, repeats, whether JAX's stack takes its scan path)."""
    c = detect_cycle(layers)
    repeats = len(layers) // c
    return c, repeats, repeats >= MIN_SCAN_REPEATS


def _stat(x):
    """(finite?, max|x|) taken in float32 (an inf survives the upcast), as
    0-d tensors."""
    x32 = x.float()
    return torch.isfinite(x32).all(), x32.abs().max()


def _sub(params, prefix: str):
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _dense(params, name: str, x):
    return x @ params[f"{name}.w"] + params[f"{name}.b"]


def _probed_forward(model, cp, signal, use_scan: bool, cycle: int):
    """RawCTCNet's forward (models/raw_ctcnet.py) on params cp, with a
    probe after every section. Returns (logits, probes [(name, finite,
    max_abs)], per-cycle or per-block maxima of (out, skips))."""
    probes = []
    h = model.feature_kwidth - 1
    out = _conv1d(signal, cp["feat_conv.w"], dilation=1, pad_left=h, pad_right=h) \
        + cp["feat_conv.b"]
    probes.append(("feat_conv",) + _stat(out))
    out = leaky_relu(out)
    out = out @ cp["feat_1x1.w"][0] + cp["feat_1x1.b"]
    probes.append(("feat_1x1",) + _stat(out))
    out = leaky_relu(out)
    if model.positions:
        pos = torch.arange(out.shape[1], dtype=out.dtype, device=out.device)[None, :, None]
        out = out + hardtanh(_dense(cp, "positions_1x1", pos))
        probes.append(("positions",) + _stat(out))
    out, skip = functional_call(model.input_block, _sub(cp, "input_block."), (out,))
    probes.append(("input_block",) + _stat(out))
    skips = _dense(cp, "input_bottleneck", skip)
    mo, ms = [], []
    for i, blk in enumerate(model.stack.blocks):
        out, skip = functional_call(blk, _sub(cp, f"stack.blocks.{i}."), (out,))
        # the stack's own order of the sum (models/stack.py), which bf16 rounds
        skips = skips + skip @ cp[f"stack.bottlenecks.{i}.w"] + cp[f"stack.bottlenecks.{i}.b"]
        if not use_scan or (i + 1) % cycle == 0:  # JAX probes a scan after each cycle
            mo.append(_stat(out)[1])
            ms.append(_stat(skips)[1])
    mo, ms = torch.stack(mo), torch.stack(ms)
    kind = "cycles" if use_scan else "blocks"
    probes += [(f"{kind}_out", torch.isfinite(mo).all(), mo.max()),
               (f"{kind}_skips", torch.isfinite(ms).all(), ms.max())]
    hh = _dense(cp, "out1", leaky_relu(skips))
    probes.append(("out1",) + _stat(hh))
    logits = _dense(cp, "out2", leaky_relu(hh))
    probes.append(("logits",) + _stat(logits))
    return logits, probes, (mo, ms)


def section_report(model, params, batch: Dict[str, np.ndarray], compute_dtype=None,
                   preprocess=None, average_per_logit: bool = True) -> Dict[str, Any]:
    """Stage-by-stage numeric health of one RawCTCNet train step.

    model: a ``models.RawCTCNet``; params: its params {name: tensor} (the
    step's tree; the model's own weights are not read); batch: numpy
    arrays "signal", "labels", "label_lengths", moved to the params'
    device. The forward is RawCTCNet's with probes (checked: its logits
    must match the model's forward, ``probe_matches_model_apply``), then
    the backward with each top-level group's gradient stats and the
    float32 sum of squares it adds to a naive global norm, which overflows
    float32 on gradients of 1e19 and more.

    Returns {"compute_dtype", "loss", "stages": [(name, finite, max_abs),
    ... in execution order], "grads": {group: {"finite", "max_abs",
    "sumsq_f32"}}, "gnorm_sumsq_f32", "per_cycle_max_out",
    "per_cycle_max_skips", "probe_matches_model_apply"}."""
    c, _, use_scan = scan_config(model.layers)
    dev = next(iter(params.values())).device
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    signal = torch.as_tensor(batch["signal"], dtype=torch.float32, device=dev)
    if preprocess is not None:
        signal = preprocess(signal)
    signal = _cast(signal, compute_dtype)
    labels = torch.as_tensor(batch["labels"], device=dev)
    label_lengths = torch.as_tensor(batch["label_lengths"], device=dev)

    cp = _cast(leaves, compute_dtype)
    logits, probes, (mo, ms) = _probed_forward(model, cp, signal, use_scan, c)
    # the model's own forward on the same tensors, with autograd on as for
    # the probes: on the card the bf16 forward under no_grad rounded apart
    # from the probed one by more than the check's 1e-3
    ref = functional_call(model, cp, (signal,)).detach()
    B, T = logits.shape[:2]
    per_seq = ctc_loss_per_seq(logits, torch.full((B,), T, dtype=torch.int32, device=dev),
                               labels, label_lengths)
    loss = per_seq.sum() / T if average_per_logit else per_seq.sum()
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True,
                                materialize_grads=True)
    groups: Dict[str, list] = {}
    for k, g in zip(names, grads):
        groups.setdefault(k.split(".")[0], []).append(g.float())
    gstats = {k: {"finite": bool(torch.stack([torch.isfinite(g).all() for g in gs]).all()),
                  "max_abs": float(torch.stack([g.abs().max() for g in gs]).max()),
                  "sumsq_f32": float(sum(torch.sum(torch.square(g)) for g in gs))}
              for k, gs in sorted(groups.items())}  # JAX's dict of grads is key-sorted

    stages = [(n, bool(f), float(m.detach())) for n, f, m in probes]
    stages.append(("ctc_per_seq",) + tuple(t.item() for t in _stat(per_seq.detach())))
    report = {
        "compute_dtype": str(compute_dtype).replace("torch.", "") if compute_dtype
        else "float32",
        "loss": float(loss.detach()),
        "stages": stages,
        "grads": gstats,
        "gnorm_sumsq_f32": float(sum(v["sumsq_f32"] for v in gstats.values())),
        "per_cycle_max_out": [float(x) for x in mo.detach().cpu()],
        "per_cycle_max_skips": [float(x) for x in ms.detach().cpu()],
    }
    # cross-check: the probed forward is the model's forward
    lg, rf = logits.detach().float().cpu().numpy(), ref.float().cpu().numpy()
    both = np.isfinite(lg) & np.isfinite(rf)
    report["probe_matches_model_apply"] = bool(
        np.array_equal(np.isfinite(lg), np.isfinite(rf))
        and (not both.any() or float(np.max(np.abs(lg[both] - rf[both])))
             <= 1e-3 * max(1.0, float(np.max(np.abs(rf[both]))))))
    return report


def first_nonfinite(report: Dict[str, Any]) -> Optional[str]:
    """Name of the first stage (execution order; grads after the forward)
    that is non-finite, or None."""
    for name, finite, _ in report["stages"]:
        if not finite:
            return name
    if not np.isfinite(report["loss"]):
        return "loss"
    for k, v in report["grads"].items():
        if not v["finite"]:
            return f"grad:{k}"
    if not np.isfinite(report["gnorm_sumsq_f32"]):
        return "global_norm_sumsq"
    return None
