#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (wavenet_speech_tpu_torch) on
one NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``wavenet_speech_tpu_torch/csrc``,
then, at the full width of the bench model (WaveNet 30 blocks + classifier
18 blocks, 256 channels, 5 labels; random weights from a seed; B=8 one-hot
reads of L=4505):

  1. holds the fused gated block kernel against its plain version at every
     one of the 30 dilations, on the activations the forward feeds it;
  2. holds the prefix beam kernel against its plain version on the
     log-softmax of the real forward's logits (W=7, S=4608, lengths 1126);
  3. at the port's own init, holds the kernel forward's logit difference
     from the plain forward to at most SENS_FACTOR times that of the same
     forward built on cuDNN (the untrained full-width forward amplifies any
     f32 rounding difference; see PERF.md);
  4. with every block's res_w scaled by 1/sqrt(2), which keeps the residual
     stream's scale, basecalls the reads through ``Basecaller`` (beam W=7,
     then greedy), counting kernel launches, and checks the strings against
     the same pipeline run with both plain versions, and a small model
     against the CPU;
  5. trains: the f32 joint step of bench.py:105-149 (JointLoss, Adagrad
     3e-5, the bench batch of B=8 reads, S=429 labels) at full width.
     At the port's init, and again with res_w scaled as in 4, it holds
     the kernel step's gradients to at most SENS_FACTOR times the
     cuDNN-composite step's distance from the plain step's; holds the
     fused block's backward kernel (B5) at every dilation and the CTC
     alpha and beta kernels (B1, B2) against their plain versions on the
     inputs the real backward feeds them (and the CTC against
     F.ctc_loss); takes 3 steps counting launches (B4 30, B5 30, B1 1,
     B2 1 a step) and holds their updates to the same cuDNN yardstick
     against 3 steps on the plain versions; checks a small model's 3
     steps against the CPU's; and times the step.

Every failure raises, so the script exits non-zero; without CUDA (or
without the package beside it) it exits non-zero before printing any
result. The second-to-last line is a JSON object of per-kernel numbers,
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from wavenet_speech_tpu_torch.decoding import ctc_beam_device
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, beam_finalize, beam_search_kernel, beam_search_ref, ctc_beam_search)
from wavenet_speech_tpu_torch.decoding.greedy import greedy_ctc_decode
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.inference import Basecaller
from wavenet_speech_tpu_torch.models import blocks
from wavenet_speech_tpu_torch.ops import _build, ctc_scan
from wavenet_speech_tpu_torch.ops.activations import gated_activation
from wavenet_speech_tpu_torch.ops.ctc import (NEG, _extend_labels, _gather_ext,
                                              ctc_loss)
from wavenet_speech_tpu_torch.ops.ctc_scan import (ctc_bwd, ctc_bwd_ref, ctc_fwd,
                                                   ctc_fwd_ref)
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref,
                                                      fused_gated_block_ref)
from wavenet_speech_tpu_torch.training import (JointLoss, TrainState, build_optimizer,
                                               make_joint_train_step, param_tree)
from wavenet_speech_tpu_torch.training.trainer import all_finite, global_norm_safe
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

SEED = 0
B, L = 8, 4505                       # bench.py:105-149 batch and read length
LEVELS, LABELS, POOL = 256, 5, 4
WAVENET_DILS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512] * 3
CLASSIFIER_DILS = [1, 2, 4, 8, 16, 32] * 3
BEAM_WIDTH = 7
# published H100 SXM peaks (NVIDIA data sheet) at a 700 W power limit
PEAK_F32_FLOPS = 67e12               # float32 outside the tensor cores
PEAK_BYTES = 3.35e12                 # HBM3
# B4 tolerance: |kernel - plain| <= B4_RTOL * |plain| + B4_ATOL * max|plain|.
# Both sum the same f32 products (512 and 256 terms a block) in another
# order, so the error scales with the tensor's magnitude, which the
# residual stream roughly doubles in variance at each block.
B4_RTOL, B4_ATOL = 1e-4, 1e-5
BEAM_SCORE_ATOL = 1e-3
# At the real init: kernel forward's max logit difference from the plain
# forward <= SENS_FACTOR x the cuDNN-composite forward's. Both blocks err
# like cuDNN's at every block (phase 1), so the two differences are the same
# rounding amplified by the same ill-conditioned stack.
SENS_FACTOR = 4.0
# training (bench.py:105-149): S labels, Adagrad learning rate, steps
S_LABELS, TRAIN_LR, TRAIN_STEPS = 429, 3e-5, 3
# B5 tolerance: |kernel - plain| <= B4_RTOL * |plain| + atol * max|plain|,
# atol B4_ATOL for dx (sums of K*2C + C = 1280 products, like B4's) and
# B5_WGRAD_ATOL for the six weight and bias gradients: sums over the
# B*L = 36,040 frames, which the kernel adds in 16 slices of 2,253 frames
# each summed in sequence, where cuBLAS sums in blocks.
B5_WGRAD_ATOL = 1e-4
# B1/B2: the plain loop's arithmetic in another order of the logaddexp's
# exp/log1p implementations; as tests/test_pallas_ctc.py
CTC_RTOL, CTC_ATOL, CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-5, 1e-5, 1e-4, 1e-6
# the port's CTC against F.ctc_loss (an independent f32 implementation):
# the summed loss within CTC_LIB_RTOL; d loss / d logits (each in [-1, 1])
# within sqrt(T) * eps32 * max|ll|: an occupancy exp(alpha + beta - ll)
# carries the rounding of T additions at the magnitude of ll, a random walk
# of sqrt(T) ulps of |ll|, which two implementations that add in another
# order do not share
CTC_LIB_RTOL = 1e-4
# 3 kernel steps against 3 plain-version steps: ||p_kernel - p_plain|| /
# ||p_plain|| <= STEP_PARAM_RTOL, and over the updates dp = p_3 - p_0
# ||dp_kernel - dp_plain|| / ||dp_plain|| <= SENS_FACTOR x the same for 3
# steps with the causal blocks on the cuDNN composite: the gradients of the
# untrained stack amplify f32 rounding even with res_w scaled (PERF.md)
STEP_PARAM_RTOL = 1e-4


def log(*a):
    print(*a, flush=True)


def cfg_full_width():
    return {"model": {
        "base": {"signal_dim": LEVELS, "entry_kwidth": 2, "kernel": 2,
                 "dilations": WAVENET_DILS},
        "classifier": {"kernel": 2, "dilations": CLASSIFIER_DILS,
                       "downsample": POOL, "num_labels": LABELS}}}


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of fn() over reps launches, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def onehot_reads(rng, n, length, levels):
    lv = rng.integers(0, levels, size=(n, length))
    x = np.zeros((n, length, levels), np.float32)
    x[np.arange(n)[:, None], np.arange(length)[None, :], lv] = 1.0
    return x


def compare_beams(got, want, width):
    """Finalized beams: live rows must hold equal prefixes, lengths and
    times, scores within BEAM_SCORE_ATOL. Returns (live rows, max score
    error)."""
    p1, l1, s1, t1 = (x.cpu() for x in got)
    p0, l0, s0, t0 = (x.cpu() for x in want)
    live, err = 0, 0.0
    for b in range(p0.shape[0]):
        for r in range(width):
            if s0[b, r] <= NEG_INF / 2:
                break
            n = int(l0[b, r])
            if int(l1[b, r]) != n:
                raise AssertionError(f"beam: read {b} rank {r} length {int(l1[b, r])} != {n}")
            if not (torch.equal(p1[b, r, :n], p0[b, r, :n])
                    and torch.equal(t1[b, r, :n], t0[b, r, :n])):
                raise AssertionError(f"beam: read {b} rank {r} prefix or times differ")
            err = max(err, abs(float(s1[b, r]) - float(s0[b, r])))
            live += 1
    if live == 0 or err > BEAM_SCORE_ATOL:
        raise AssertionError(f"beam: {live} live rows, max score error {err}")
    return live, err


def cudnn_block(x, gw, gb, ow, ob, rw, rb, d):
    """The fused block as a cuDNN conv + matmuls: a yardstick the port never
    calls."""
    xp = F.pad(x.transpose(1, 2), ((gw.shape[0] - 1) * d, 0))
    g = F.conv1d(xp, gw.permute(2, 1, 0), gb, dilation=d).transpose(1, 2)
    C = rw.shape[1]
    o = torch.matmul(gated_activation(g[..., :C], g[..., C:]), ow) + ob
    return o[..., :C] + torch.matmul(x, rw) + rb, o[..., C:]


def phase_fused_block(model, x_entry):
    """B4 against its plain version on the input each of the 30 blocks gets
    in the forward (the plain path's activations)."""
    rows, x = [], x_entry
    for blk in model.model_base.stack.blocks:
        a = (blk.gate_w, blk.gate_b, blk.out_w[0], blk.out_b, blk.res_w, blk.res_b)
        d = blk.dilation
        got = fused_gated_block(x, *a, d)
        want = fused_gated_block_ref(x, *a, d)
        lib = cudnn_block(x, *a, d)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            bad = ((g - w).abs() > B4_RTOL * w.abs() + B4_ATOL * scale).sum()
            if bad:
                raise AssertionError(f"B4 d={d}: {int(bad)} elements beyond tolerance; "
                                     f"max_abs_err {err:.3e}, max|plain| {scale:.3e}")
        lib_err = max(float((g - w).abs().max()) for g, w in zip(lib, want))
        rows.append(dict(
            d=d, err=err, lib_err=lib_err, scale=scale,
            ms=cuda_ms(lambda: fused_gated_block(x, *a, d), 5),
            plain_ms=cuda_ms(lambda: fused_gated_block_ref(x, *a, d), 5),
            library_ms=cuda_ms(lambda: cudnn_block(x, *a, d), 5)))
        x = want[0]
    Bx, Lx, C_in = x_entry.shape
    K, _, C2 = model.model_base.stack.blocks[0].gate_w.shape
    C = C2 // 2
    flops = 2 * Bx * Lx * (K * C_in * C2 + C * C2 + C_in * C)
    nbytes = 4 * (Bx * Lx * C_in + 2 * Bx * Lx * C
                  + K * C_in * C2 + C2 + C * C2 + C2 + C_in * C + C)
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    for r in rows:
        log(f"  B4 d={r['d']:3d}  max|plain|={r['scale']:.3e} max_abs_err={r['err']:.3e} "
            f"(library's {r['lib_err']:.3e})  kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}")
    mean = lambda k: sum(r[k] for r in rows) / len(rows)
    summary = dict(err=max(r["err"] for r in rows), ms=mean("ms"),
                   plain_ms=mean("plain_ms"), library_ms=mean("library_ms"),
                   bound_ms=bound_ms, bound_by=bound_by)
    log(f"B4 fused_gated_block: 30 dilations within rtol {B4_RTOL}, atol {B4_ATOL} "
        f"x max|plain|; "
        f"max_abs_err={summary['err']:.3e}; kernel_ms={summary['ms']:.4f} "
        f"plain_ms={summary['plain_ms']:.4f} library_ms={summary['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP at "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32, {nbytes / 1e6:.1f} MB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s); mean over the 30 blocks")
    return summary


def phase_beam(lp, lengths, S):
    """B6 against its plain version on the real forward's log-probs."""
    kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
    got = beam_finalize(beam_search_kernel(lp, lengths, **kw))
    plain_ms, want = host_ms(lambda: beam_finalize(beam_search_ref(lp, lengths, **kw)))
    live, err = compare_beams(got, want, BEAM_WIDTH)
    ms = cuda_ms(lambda: beam_search_kernel(lp, lengths, **kw), 5)
    Bx, T, C = lp.shape
    N = BEAM_WIDTH * (1 + C)  # candidates a frame scores
    frames = int(lengths.clamp(max=T).sum())
    ops = frames * N * (4 + math.ceil(math.log2(N)))  # logaddexp + a selection
    nbytes = 4 * (Bx * T * C + Bx + 2 * Bx * BEAM_WIDTH * S + 3 * Bx * BEAM_WIDTH)
    bound_ms = max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    log(f"B6 ctc_beam: {live} live beam rows equal (prefixes, lengths, times), "
        f"max score error {err:.3e} (tolerance {BEAM_SCORE_ATOL}); "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound_ms:.6f} "
        f"({bound_by}); best length {int(want[1][0, 0])}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def plain_versions():
    """Route the model and the beam through the kernels' plain versions."""
    stack = causal_blocks_as(fused_gated_block_ref)
    beam = mock.patch.object(ctc_beam_device, "beam_search_kernel",
                             ctc_beam_device.beam_search_ref)
    return stack, beam


def causal_blocks_as(fn):
    """Run the WaveNet's causal blocks through fn instead of the kernel."""
    return mock.patch.object(blocks, "fused_gated_block", fn)


def report_sensitivity(label, logits, plain_logits, lengths, S):
    """Logit difference between a forward and the plain forward, and how
    many reads it changes the basecalls of (both decoded by the kernels)."""
    def calls(lg):
        p, n, sc = ctc_beam_search(lg, lengths, beam_width=BEAM_WIDTH, max_label_len=S)
        beams = [tuple(p[b, 0, : int(n[b, 0])].tolist()) for b in range(B)]
        return beams, greedy_ctc_decode(lg, lengths.cpu().numpy()), sc[:, 0]

    (b1, g1, s1), (b0, g0, s0) = calls(logits), calls(plain_logits)
    diff = float((logits - plain_logits).abs().max())
    log(f"{label}: max logit diff from the plain forward {diff:.3e} (logit std "
        f"{float(plain_logits.std()):.3e}); reads with other basecalls: beam "
        f"{sum(a != b for a, b in zip(b1, b0))}/{B}, greedy "
        f"{sum(a != b for a, b in zip(g1, g0))}/{B}; max beam score diff "
        f"{float((s1 - s0).abs().max()):.3e}")
    return diff


# ---- 5. training --------------------------------------------------------------

def ctc_plain():
    """Run the CTC recursion through B1's and B2's plain versions."""
    return mock.patch.multiple(ctc_scan, ctc_fwd=ctc_fwd_ref, ctc_bwd=ctc_bwd_ref)


def reset_counts():
    fused_gated_block.launches = fused_gated_block_bwd.launches = 0
    ctc_fwd.launches = ctc_bwd.launches = beam_search_kernel.launches = 0


def read_counts():
    return {"fused_gated_block": fused_gated_block.launches,
            "fused_gated_block_bwd": fused_gated_block_bwd.launches,
            "ctc_alpha": ctc_fwd.launches, "ctc_beta": ctc_bwd.launches,
            "ctc_beam": beam_search_kernel.launches}


def bench_batch(dev):
    """bench.py:137-149: B one-hot reads of L levels, S labels in 1..4, full
    lengths, from a fresh generator on the seed."""
    rng = np.random.default_rng(SEED)
    signal = onehot_reads(rng, B, L, LEVELS)
    labels = rng.integers(1, LABELS, size=(B, S_LABELS))
    return {"signal": torch.from_numpy(signal).to(dev),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(dev),
            "label_lengths": torch.full((B,), S_LABELS, dtype=torch.int32, device=dev),
            "signal_lengths": torch.full((B,), L, dtype=torch.int32, device=dev)}


def joint_loss(model, batch):
    """The train step's objective on the model's own parameters."""
    sig = batch["signal"]
    pred = model.model_base(sig)
    logits = model.model_ctc(pred)
    return JointLoss("joint").total(sig, pred, logits, batch["labels"],
                                    batch["label_lengths"]), logits


def loss_grads(model, batch):
    loss, _ = joint_loss(model, batch)
    return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                               materialize_grads=True)


def rel_err(a, b):
    """||a - b|| / ||b|| over lists of tensors, by the overflow-proof norm."""
    return float(global_norm_safe([x - y for x, y in zip(a, b)]) / global_norm_safe(list(b)))


def phase_grad_ratio(model, batch, label):
    """The kernel step's gradients no farther from the plain step's than
    SENS_FACTOR x the cuDNN-composite step's (as phase 3 for logits)."""
    g_k = loss_grads(model, batch)
    with causal_blocks_as(fused_gated_block_ref), ctc_plain():
        g_p = loss_grads(model, batch)
    with causal_blocks_as(cudnn_block), ctc_plain():
        g_c = loss_grads(model, batch)
    k, c = rel_err(g_k, g_p), rel_err(g_c, g_p)
    log(f"{label}, gradients of the joint loss: ||g - g_plain|| / ||g_plain|| kernel "
        f"{k:.3e}, cuDNN composite {c:.3e}, ratio {k / c:.3f} (bound {SENS_FACTOR}); "
        f"||g_plain|| {float(global_norm_safe(list(g_p))):.3e}")
    if not k <= SENS_FACTOR * c:
        raise AssertionError(f"{label}: kernel gradients' error {k:.3e} > "
                             f"{SENS_FACTOR} x the cuDNN step's {c:.3e}")


def capture_backward(model, batch):
    """The plain step's forward and backward: each causal block's input and
    output cotangents, and the CTC's extended log-probs and cotangent."""
    rec = []

    def recorder(x, gw, gb, ow, ob, rw, rb, d):
        r, s = fused_gated_block_ref(x, gw, gb, ow, ob, rw, rb, d)
        rec.append((x.detach(), [w.detach() for w in (gw, gb, ow, rw)], d, r, s))
        return r, s

    with causal_blocks_as(recorder), ctc_plain():
        loss, logits = joint_loss(model, batch)
        outs = [t for _, _, _, r, s in rec for t in (r, s)]
        cots = torch.autograd.grad(loss, outs, allow_unused=True, materialize_grads=True)
    blocks_io = [(x, w, d, cots[2 * i], cots[2 * i + 1])
                 for i, (x, w, d, _, _) in enumerate(rec)]
    logits = logits.detach()
    ext, allow = _extend_labels(batch["labels"], 0)
    lp_ext = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
    return blocks_io, logits, lp_ext, torch.where(allow, 0.0, NEG)


def cudnn_block_bwd(x, w, d, dr, ds):
    """The backward of the cuDNN composite by autograd: the yardstick the
    port never calls. Returns a function that runs it again."""
    gw, gb, ow, rw = (t.detach().requires_grad_(True) for t in w)
    ob = torch.zeros_like(gb, requires_grad=True)
    rb = torch.zeros_like(rw[0], requires_grad=True)
    x = x.detach().requires_grad_(True)
    r, s = cudnn_block(x, gw, gb, ow, ob, rw, rb, d)
    return lambda: torch.autograd.grad((r, s), (x, gw, gb, ow, ob, rw, rb), (dr, ds),
                                       retain_graph=True)


B5_OUTPUTS = ("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr")


def phase_fused_block_bwd(blocks_io):
    """B5 against its plain version at each of the 30 dilations, on the
    inputs and cotangents of the real backward."""
    rows = []
    for x, w, d, dr, ds in blocks_io:
        got = fused_gated_block_bwd(x, *w, dr, ds, d)
        want = fused_gated_block_bwd_ref(x, *w, dr, ds, d)
        lib_fn = cudnn_block_bwd(x, w, d, dr, ds)
        lib = lib_fn()
        torch.cuda.synchronize()
        errs, lib_errs, scales = [], [], []
        for name, g, p, c in zip(B5_OUTPUTS, got, want, lib):
            scale = float(p.abs().max())
            err = float((g - p).abs().max())
            atol = B4_ATOL if name == "dx" else B5_WGRAD_ATOL
            bad = int(((g - p).abs() > B4_RTOL * p.abs() + atol * scale).sum())
            if bad:
                raise AssertionError(f"B5 d={d} {name}: {bad} elements beyond tolerance; "
                                     f"max_abs_err {err:.3e}, max|plain| {scale:.3e}")
            errs.append(err)
            lib_errs.append(float((c - p).abs().max()))
            scales.append(scale)
        rows.append(dict(
            d=d, errs=errs, lib_errs=lib_errs, scales=scales,
            ms=cuda_ms(lambda: fused_gated_block_bwd(x, *w, dr, ds, d), 3),
            plain_ms=cuda_ms(lambda: fused_gated_block_bwd_ref(x, *w, dr, ds, d), 3),
            library_ms=cuda_ms(lib_fn, 3)))
    Bx, Lx, C_in = blocks_io[0][0].shape
    K, _, C2 = blocks_io[0][1][0].shape
    C = C2 // 2
    n = Bx * Lx
    flops = 2 * n * (K * C_in * C2 + C2 * C          # gate recompute, da
                     + K * C2 * C_in + C * C_in      # dx
                     + K * C_in * C2 + C * C2 + C_in * C)  # weight gradients
    grads_out = K * C_in * C2 + C2 + C * C2 + C2 + C_in * C + C
    nbytes = 4 * (n * (C_in + 2 * C + C_in)          # x, dresid, dskip in; dx out
                  + K * C_in * C2 + C2 + C * C2 + C_in * C + grads_out)
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    for r in rows:
        log(f"  B5 d={r['d']:3d} max_abs_err/max|plain| "
            + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, e, s in zip(B5_OUTPUTS, r["errs"],
                                                                 r["scales"]))
            + f" (library's max {max(r['lib_errs']):.2e}) kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}")
    mean = lambda k: sum(r[k] for r in rows) / len(rows)
    worst = [max(r["errs"][i] for r in rows) for i in range(len(B5_OUTPUTS))]
    worst_lib = [max(r["lib_errs"][i] for r in rows) for i in range(len(B5_OUTPUTS))]
    summary = dict(err=max(worst), ms=mean("ms"), plain_ms=mean("plain_ms"),
                   library_ms=mean("library_ms"), bound_ms=bound_ms, bound_by=bound_by)
    log(f"B5 fused_gated_block_bwd: {len(rows)} dilations within rtol {B4_RTOL}, atol {B4_ATOL} "
        f"(dx) / {B5_WGRAD_ATOL} (weights, biases) x max|plain|; max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in zip(B5_OUTPUTS, worst))
        + "; cuDNN-composite autograd's " + " ".join(f"{k}={e:.3e}" for k, e in
                                                      zip(B5_OUTPUTS, worst_lib))
        + f"; kernel_ms={summary['ms']:.4f} plain_ms={summary['plain_ms']:.4f} "
        f"library_ms={summary['library_ms']:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); mean over the 30 blocks")
    return summary


def check_close(name, got, want, rtol, atol):
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: beyond rtol {rtol}, atol {atol}; max_abs_err {err:.3e}")
    return err


def phase_ctc(lp, skip, logits, batch):
    """B1 and B2 against their plain versions on the real step's extended
    log-probs, the cotangent d loss / d ll = -1/T of JointLoss; the port's
    CTC against F.ctc_loss (loss and gradient), the yardstick."""
    T, Bx, J = lp.shape
    lens = torch.full((Bx,), T, dtype=torch.int32, device=lp.device)
    lab, labels = batch["label_lengths"], batch["labels"]
    cot = torch.full((Bx,), -1.0 / T, device=lp.device)
    got = ctc_fwd(lp, skip, lens, lab)
    plain_fwd_ms, want = host_ms(lambda: ctc_fwd_ref(lp, skip, lens, lab))
    err1 = max(check_close("B1 ll", got[0], want[0], CTC_RTOL, CTC_ATOL),
               check_close("B1 alphas", got[1], want[1], CTC_RTOL, CTC_ATOL))
    gg, _ = ctc_bwd(lp, want[1], skip, lens, lab, want[0], cot)
    plain_bwd_ms, (gw, _) = host_ms(
        lambda: ctc_bwd_ref(lp, want[1], skip, lens, lab, want[0], cot))
    err2 = check_close("B2 grad", gg, gw, CTC_GRAD_RTOL, CTC_GRAD_ATOL)

    x = logits.clone().requires_grad_(True)
    ours = ctc_loss(x, lens, labels, lab)
    g_ours, = torch.autograd.grad(ours, x)
    y = logits.clone().requires_grad_(True)
    lib_args = (labels.long(), lens.long(), lab.long())
    lib = F.ctc_loss(torch.log_softmax(y, -1).transpose(0, 1), *lib_args, reduction="sum")
    g_lib, = torch.autograd.grad(lib, y)
    ours, lib = float(ours.detach()), float(lib.detach())
    loss_rel = abs(ours - lib) / abs(lib)
    g_err = float((g_ours - g_lib).abs().max())
    g_tol = math.sqrt(T) * torch.finfo(torch.float32).eps * float(want[0].abs().max())
    log(f"CTC against F.ctc_loss: loss {ours:.6e} vs {lib:.6e} (rel "
        f"{loss_rel:.2e}, bound {CTC_LIB_RTOL}); d loss / d logits max diff {g_err:.2e} "
        f"(bound sqrt(T) eps max|ll| = {g_tol:.2e}, max|ll| {float(want[0].abs().max()):.1f})")
    if loss_rel > CTC_LIB_RTOL or g_err > g_tol:
        raise AssertionError("the port's CTC disagrees with F.ctc_loss")

    ms1 = cuda_ms(lambda: ctc_fwd(lp, skip, lens, lab), 5)
    ms2 = cuda_ms(lambda: ctc_bwd(lp, want[1], skip, lens, lab, want[0], cot), 5)
    lp_lib = torch.log_softmax(logits, -1).transpose(0, 1).contiguous().requires_grad_(True)
    lib_fwd_ms = cuda_ms(lambda: F.ctc_loss(lp_lib.detach(), *lib_args, reduction="sum"), 5)
    lib_loss = F.ctc_loss(lp_lib, *lib_args, reduction="sum")
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_loss, lp_lib, retain_graph=True), 5)
    states = T * Bx * J
    live = int(lens.clamp(max=T).sum()) * J     # every frame is live here
    # a live state: two logaddexps (max, sub, abs, exp, log1p, add) and two
    # adds for B1; B2 adds the occupancy (add, sub, exp, mul)
    ops1, ops2 = 14 * live, 18 * live
    bytes1 = 4 * (2 * states + 3 * Bx * J + 3 * Bx)
    bytes2 = 4 * (3 * states + 3 * Bx * J + 4 * Bx)
    out = []
    for name, ms, plain_ms, lib_ms, ops, nbytes, err in (
            ("B1 ctc_alpha", ms1, plain_fwd_ms, lib_fwd_ms, ops1, bytes1, err1),
            ("B2 ctc_beta", ms2, plain_bwd_ms, lib_bwd_ms, ops2, bytes2, err2)):
        bound_ms = max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"{name}: T={T} B={Bx} J={J}; max_abs_err={err:.3e}; kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.1f} library_ms={lib_ms:.4f} (F.ctc_loss "
            f"{'forward' if 'alpha' in name else 'backward'}) bound_ms={bound_ms:.6f} "
            f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e6:.0f} M ops)")
        out.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by))
    return out


def train_steps(step, state, batch, expect=None):
    """TRAIN_STEPS steps; with expect, the launch counts of every step must
    equal it. Returns (state, per-step metrics, first step's counts)."""
    history, first = [], None
    for i in range(TRAIN_STEPS):
        reset_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        first = first or counts
        if expect is not None and counts != expect:
            raise AssertionError(f"train step {i + 1} launches {counts}, expected {expect}")
        if not (torch.isfinite(m["total_loss"]) and int(m["skipped_nonfinite"]) == 0):
            raise AssertionError(f"train step {i + 1}: loss {float(m['total_loss'])}, "
                                 f"skipped {int(m['skipped_nonfinite'])}")
        history.append({k: float(v) for k, v in m.items()})
    return state, history, first


def phase_train_steps(model, batch):
    """The main path: 3 joint steps on the kernels, then the same 3 steps
    on the plain versions from the same state."""
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"))
    state0 = TrainState.create(param_tree(model.model_base, model.model_ctc), tx)
    expect = {"fused_gated_block": len(WAVENET_DILS),
              "fused_gated_block_bwd": len(WAVENET_DILS), "ctc_alpha": 1, "ctc_beta": 1}
    state, hist, launches = train_steps(step, state0, batch, expect)
    for i, m in enumerate(hist):
        log(f"train step {i + 1} (kernels): " + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    log(f"train steps: launches per step {launches}")
    with causal_blocks_as(fused_gated_block_ref), ctc_plain():
        pstate, phist, plaunch = train_steps(step, state0, batch)
    if plaunch:
        raise AssertionError(f"the plain steps launched kernels: {plaunch}")
    with causal_blocks_as(cudnn_block), ctc_plain():
        cstate, _, _ = train_steps(step, state0, batch)
    p0, pk, pp, pc = (tree_leaves(s.params) for s in (state0, state, pstate, cstate))
    dp = lambda p: [a - b for a, b in zip(p, p0)]
    upd_k, upd_c = rel_err(dp(pk), dp(pp)), rel_err(dp(pc), dp(pp))
    param_err = rel_err(pk, pp)
    loss_err = max(abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                   for a, b in zip(hist, phist))
    log(f"3 steps against the plain versions' 3: params ||p_k - p_p|| / ||p_p|| "
        f"{param_err:.3e} (bound {STEP_PARAM_RTOL}); updates ||dp - dp_p|| / ||dp_p|| "
        f"kernels {upd_k:.3e}, cuDNN composite {upd_c:.3e}, ratio {upd_k / upd_c:.3f} "
        f"(bound {SENS_FACTOR}); max relative loss difference {loss_err:.3e}")
    if not (param_err <= STEP_PARAM_RTOL and upd_k <= SENS_FACTOR * upd_c):
        raise AssertionError("the kernel steps differ from the plain steps beyond the bounds")
    return step, tx, state, launches


def phase_train_small(dev):
    """A small model: 3 steps on the card and on the CPU from the same
    weights; losses, metrics and params must agree."""
    cfg = {"model": {"base": {"signal_dim": 32, "dilations": [1, 2, 4, 8] * 2},
                     "classifier": {"dilations": [1, 2, 4], "downsample": POOL}}}
    rng = np.random.default_rng(SEED + 2)
    lv = rng.integers(0, 32, size=(4, 300))
    batch = {"signal": lv.astype(np.int32),   # levels: one-hot on the device
             "labels": rng.integers(1, LABELS, size=(4, 20)).astype(np.int32),
             "label_lengths": np.array([20, 17, 12, 20], np.int32),
             "signal_lengths": np.array([300, 280, 300, 250], np.int32)}
    out = []
    for device in (dev, "cpu"):
        model = Model("wavenet-ctc", cfg, device=device).init(SEED + 1)
        tx = build_optimizer("adagrad", 1e-2)
        step = make_joint_train_step(model.model_base, model.model_ctc, tx,
                                     logit_length_fn=lambda l: l // POOL)
        state = TrainState.create(param_tree(model.model_base, model.model_ctc), tx)
        hist = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items()})
        out.append((hist, [t.cpu() for t in tree_leaves(state.params)]))
    (hk, pk), (hc, pc) = out
    for a, b in zip(hk, hc):
        for k in b:
            if not math.isclose(a[k], b[k], rel_tol=1e-4, abs_tol=1e-6):
                raise AssertionError(f"small model: card {k}={a[k]} != CPU {b[k]}")
    for a, b in zip(pk, pc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    log(f"small model (32 ch, 8+3 blocks, levels on the device, length-aware): 3 steps "
        f"on the card equal the CPU's (losses {[round(h['total_loss'], 5) for h in hk]})")


def time_training(model, step, tx, state, batch):
    """Step ms and samples/s from CUDA events after a warm step; forward and
    backward ms of the same objective; the skip guard's and the optimizer
    update's ms on a tree of the params' shapes; peak memory of the steps."""
    state, _ = step(state, batch)                      # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    peak = torch.cuda.max_memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fwd = bwd = 0.0
    for _ in range(3):
        ev[0].record()
        loss, _ = joint_loss(model, batch)
        ev[1].record()
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                            materialize_grads=True)
        ev[2].record()
        torch.cuda.synchronize()
        fwd += ev[0].elapsed_time(ev[1]) / 3
        bwd += ev[1].elapsed_time(ev[2]) / 3
    g = state.params
    guard_ms = cuda_ms(lambda: (global_norm_safe(g), all_finite(g)), 3)
    update_ms = cuda_ms(lambda: tx.update(g, state.opt_state, g), 3)
    log(f"train_step_ms={step_ms:.3f} samples_per_s={B * L / step_ms * 1e3:.0f} "
        f"(f32, B={B}, L={L}, S={S_LABELS}, Adagrad; mean of {n} steps after a warm "
        f"step) forward_ms={fwd:.3f} backward_ms={bwd:.3f} skip_guard_ms={guard_ms:.3f} "
        f"optimizer_update_ms={update_ms:.3f} ({len(tree_leaves(g))} parameter tensors) "
        f"peak memory {peak / 2**30:.2f} GiB")
    return step_ms


def run_training(dev):
    batch = bench_batch(dev)
    model = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    phase_grad_ratio(model, batch, "port init")
    with torch.no_grad():      # the stream's scale kept, as in phase 4
        for blk in [*model.model_base.stack.blocks, model.model_ctc.input_block,
                    *model.model_ctc.stack.blocks]:
            blk.res_w.mul_(0.5 ** 0.5)
    phase_grad_ratio(model, batch, "scaled res_w")
    blocks_io, logits, lp_ext, skip = capture_backward(model, batch)
    b5 = phase_fused_block_bwd(blocks_io)
    del blocks_io
    b1, b2 = phase_ctc(lp_ext, skip, logits, batch)
    step, tx, state, launches = phase_train_steps(model, batch)
    phase_train_small(dev)
    time_training(model, step, tx, state, batch)
    return dict(b5=b5, b1=b1, b2=b2, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convs: every float32 product is full float32")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    secs = _build.build()
    log(f"built kernels from the checkout: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))

    dev = torch.device("cuda")
    model = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    rng = np.random.default_rng(SEED)
    reads = onehot_reads(rng, B, L, LEVELS)
    caller = Basecaller(model, beam_width=BEAM_WIDTH, logit_length_fn=lambda l: l // POOL,
                        device=dev)
    greedy = Basecaller(model, beam_width=0, logit_length_fn=lambda l: l // POOL,
                        device=dev)
    x = torch.from_numpy(caller._bucket(reads)).to(dev)    # (8, 4608, 256)
    S = x.shape[1]
    lengths = torch.full((B,), L // POOL, dtype=torch.int32, device=dev)
    log(f"model: WaveNet {len(WAVENET_DILS)} blocks + classifier {len(CLASSIFIER_DILS)} "
        f"blocks, {LEVELS} channels, {LABELS} labels; reads {B} x {L} "
        f"(bucketed to {S}); {sum(p.numel() for p in model.parameters())} params")

    with torch.inference_mode():
        # ---- 1. the fused block, all 30 dilations at the main-path shape
        b4 = phase_fused_block(model, model.model_base.entry(x))
        # ---- 2. the beam on the real forward's log-probs
        logits = model(x)
        if logits.shape != (B, S // POOL, LABELS) or not torch.isfinite(logits).all():
            raise AssertionError(f"logits {tuple(logits.shape)} not finite/shaped")
        b6 = phase_beam(torch.log_softmax(logits, -1), lengths, S)
        # ---- 3. at the port's init the untrained stack amplifies f32
        # rounding: the kernel forward must stay as close to the plain one as
        # the same forward on cuDNN does
        with causal_blocks_as(fused_gated_block_ref):
            plain_logits = model(x)
        with causal_blocks_as(cudnn_block):
            cudnn_logits = model(x)
        k_diff = report_sensitivity("port init, kernel forward", logits,
                                    plain_logits, lengths, S)
        c_diff = report_sensitivity("port init, cuDNN-composite forward", cudnn_logits,
                                    plain_logits, lengths, S)
        log(f"port init: kernel/cuDNN logit diff ratio {k_diff / c_diff:.3f} "
            f"(bound {SENS_FACTOR})")
        if not k_diff <= SENS_FACTOR * c_diff:
            raise AssertionError(f"port init: kernel forward's logit diff {k_diff:.3e} > "
                                 f"{SENS_FACTOR} x the cuDNN forward's {c_diff:.3e}")

    # The JAX init's kaiming-uniform residual projection doubles the variance
    # of the residual stream at every block (max |x| ~ 5e4 after 30 blocks),
    # so the untrained forward above turns f32 rounding differences into
    # different basecalls. Scaling res_w by 1/sqrt(2) keeps the stream's
    # scale; the model's code and shapes are unchanged.
    with torch.no_grad():
        for blk in [*model.model_base.stack.blocks, model.model_ctc.input_block,
                    *model.model_ctc.stack.blocks]:
            blk.res_w.mul_(0.5 ** 0.5)

    with torch.inference_mode():
        # ---- 4. end to end through the Basecaller: the main path
        fused_gated_block.launches = beam_search_kernel.launches = 0
        seqs, scores = caller(reads)
        launches = {"fused_gated_block": fused_gated_block.launches,
                    "ctc_beam": beam_search_kernel.launches}
        log(f"main path (beam W={BEAM_WIDTH}, res_w scaled by 1/sqrt(2)): "
            f"launches {launches}")
        if launches != {"fused_gated_block": len(WAVENET_DILS), "ctc_beam": 1}:
            raise AssertionError(f"main path launches {launches}: expected "
                                 f"{len(WAVENET_DILS)} fused blocks and 1 beam")
        fused_gated_block.launches = beam_search_kernel.launches = 0
        gseqs, _ = greedy(reads)
        if (fused_gated_block.launches, beam_search_kernel.launches) != (len(WAVENET_DILS), 0):
            raise AssertionError("greedy path launches "
                                 f"{fused_gated_block.launches}, {beam_search_kernel.launches}")
        if not all(s and set(s) <= set("AGCT") for s in seqs + gseqs):
            raise AssertionError("empty or non-ACGT basecalls")

        stack, beam = plain_versions()
        with stack, beam:
            fused_gated_block.launches = beam_search_kernel.launches = 0
            pseqs, pscores = caller(reads)
            pgseqs, _ = greedy(reads)
            if fused_gated_block.launches or beam_search_kernel.launches:
                raise AssertionError("the plain pipeline launched a kernel")
            plain_fwd_ms, plain_logits = host_ms(lambda: model(x), 3)
        logits = model(x)
        logit_err = report_sensitivity("scaled res_w, kernel forward", logits,
                                       plain_logits, lengths, S)
        # a path's log-probability moves by at most 2 max|d logit| a frame
        score_tol = BEAM_SCORE_ATOL + 2 * (L // POOL) * logit_err
        score_err = max(abs(a - b) for a, b in zip(scores, pscores))
        if pseqs != seqs or pgseqs != gseqs or score_err > score_tol:
            raise AssertionError(
                f"kernel pipeline differs from the plain pipeline: beam reads "
                f"{[i for i in range(B) if seqs[i] != pseqs[i]]}, greedy reads "
                f"{[i for i in range(B) if gseqs[i] != pgseqs[i]]}, score diff {score_err:.3e}")
        log(f"basecalls equal to the plain pipeline's (beam and greedy, {B} reads, "
            f"mean length {sum(map(len, seqs)) / B:.1f}); max beam score diff {score_err:.3e} "
            f"(bound {score_tol:.3e} from the logit diff)")

        # small model: the card's pipeline against the same weights on the CPU
        small_cfg = {"model": {"base": {"signal_dim": 32, "dilations": [1, 2, 4, 8] * 2},
                               "classifier": {"dilations": [1, 2, 4], "downsample": POOL}}}
        small = Model("wavenet-ctc", small_cfg, device=dev).init(SEED + 1)
        small_cpu = Model("wavenet-ctc", small_cfg, device="cpu").init(SEED + 1)
        sreads = onehot_reads(rng, 4, 300, 32)
        kw = dict(beam_width=BEAM_WIDTH, logit_length_fn=lambda l: l // POOL)
        s_gpu = Basecaller(small, device=dev, **kw)(sreads)
        s_cpu = Basecaller(small_cpu, device="cpu", **kw)(sreads)
        if s_gpu[0] != s_cpu[0] or max(abs(a - b) for a, b in zip(s_gpu[1], s_cpu[1])) > 1e-3:
            raise AssertionError(f"small model: card {s_gpu} != CPU {s_cpu}")
        log("small model (32 ch, 8+3 blocks): card basecalls equal the CPU's")

        # ---- timings of the main path
        fwd_ms = cuda_ms(lambda: model(x), 5)
        lp = torch.log_softmax(logits, -1)
        dec_ms = cuda_ms(lambda: beam_search_kernel(lp, lengths, beam_width=BEAM_WIDTH,
                                                    max_label_len=S), 5)
        call_ms, _ = host_ms(lambda: caller(reads), 3)
        greedy_ms, _ = host_ms(lambda: greedy(reads), 3)
    log(f"forward_ms={fwd_ms:.3f} (plain-version forward {plain_fwd_ms:.3f}) "
        f"beam_decode_ms={dec_ms:.3f} basecall_call_ms={call_ms:.3f} "
        f"greedy_call_ms={greedy_ms:.3f} reads_per_s={B / call_ms * 1e3:.2f} "
        f"samples_per_s={B * L / call_ms * 1e3:.0f} (beam W={BEAM_WIDTH}, B={B}, L={L})")
    log(f"serving peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- 5. training: the joint step at full width
    del model, caller, greedy, x, logits, plain_logits, lp
    train = run_training(dev)
    log(f"total {time.perf_counter() - t_start:.1f} s; card (nvidia-smi name, power.limit):")
    log(smi)

    kernels = [
        dict(name="fused_gated_block", route="cuda",
             source="wavenet_speech_tpu_torch/csrc/fused_block.cu",
             replaces="wavenet_speech_tpu/ops/pallas/residual_block.py:58",
             launches=launches["fused_gated_block"], max_abs_err=b4["err"],
             ms=b4["ms"], plain_ms=b4["plain_ms"], bound_ms=b4["bound_ms"],
             bound_by=b4["bound_by"], library_ms=b4["library_ms"]),
        dict(name="ctc_beam", route="cuda",
             source="wavenet_speech_tpu_torch/csrc/ctc_beam.cu",
             replaces="wavenet_speech_tpu/ops/pallas/attic/beam.py:62",
             launches=launches["ctc_beam"], max_abs_err=b6["err"],
             ms=b6["ms"], plain_ms=b6["plain_ms"], bound_ms=b6["bound_ms"],
             bound_by=b6["bound_by"], library_ms=None),
        dict(name="fused_gated_block_bwd", route="cuda",
             source="wavenet_speech_tpu_torch/csrc/fused_block_bwd.cu",
             replaces="wavenet_speech_tpu/ops/pallas/residual_block.py:201",
             launches=train["launches"]["fused_gated_block_bwd"],
             max_abs_err=train["b5"]["err"], ms=train["b5"]["ms"],
             plain_ms=train["b5"]["plain_ms"], bound_ms=train["b5"]["bound_ms"],
             bound_by=train["b5"]["bound_by"], library_ms=train["b5"]["library_ms"]),
    ]
    for key, name, line in (("b1", "ctc_alpha", 83), ("b2", "ctc_beta", 142)):
        k = train[key]
        kernels.append(dict(
            name=name, route="cuda", source="wavenet_speech_tpu_torch/csrc/ctc.cu",
            replaces=f"wavenet_speech_tpu/ops/pallas/ctc.py:{line}",
            launches=train["launches"][name], max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
