#!/usr/bin/env python3
"""Correctness smoke of the PyTorch/CUDA port (wavenet_speech_tpu_torch) on
one NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

It holds the port's kernels and paths against their plain versions, at full
widths, on real activations and through whole paths (CLI, meshes, long reads,
the quality harness). It times nothing: speed is measured by the benchmark,
``python3 -m h100_bench.run``.

It sets torch's own numerics first and checks that the port's first entry
point turns them to the port's (full float32, deterministic cuDNN;
utils/device.py) and that every phase leaves them so. Then it builds
``wavenet_speech_tpu_torch/csrc`` and, on the bench model (WaveNet 30 blocks
+ classifier 18, 256 channels, 5 labels; B=8 one-hot reads of L=4505):

  1. B4 against its plain version at each of the 30 dilations.
  2. B6 against its plain version on the forward's log-probs; two chained
     calls against one.
  3. At the port's init, the kernel forward's logit gap from the plain
     forward within SENS_FACTOR x the cuDNN composite's.
  4. Basecaller (beam, greedy) against the plain pipeline, launches counted,
     a small model against the CPU; the causal block's four kernels at
     widths they pad (PAD_BLOCK).
  5. The f32 joint train step: gradients to the cuDNN yardstick, B5 at every
     dilation, B4/B5 at the centred blocks, B1/B2 against their plain loops
     and F.ctc_loss, 3 steps against the plain versions'.
  6. The same in bf16: B4-bf16/B5-bf16 against their plain bf16 versions,
     gradients and updates to the bf16 cuDNN yardstick, at depths cut to
     3+2 (held) and 10+6 blocks.
  7. The train entry point on configs/ecoli_hdf5.json, run and resumed:
     logs, checkpoints, launches; B4/B5-bf16 at its blocks.
  8. SP and DP on 2 gloo ranks of this card (NCCL with 2 cards) against one
     device: B3 and its chain, B4/B5 on the halo windows, gradients, updates.
  9. Long reads on configs/gauss_quality.json's RawCTCNet: chunked forwards
     against monolithic, the streamed beam against one B6 call and against
     its plain version, the basecall command; a causal WaveNet's chunks.
 10. configs/gauss_quality.json through train and resume, BatchNorm's
     running statistics, B1/B2, make_ctc_train_step against the plain CTC,
     evaluate against its recomputation, two seeded runs bit-equal.
 11. The HDF5 read path: the real-read fixture rebuilt, the real-read
     overfit, configs/ecoli_hdf5_quality.json through train, a levels step
     against its one-hot, evaluate.
 12. The quality harness at full width: train, resume, --eval-only, the
     evaluation recomputed (plain CTC, plain beam, native engine),
     bisect_nonfinite on poisoned params, the --smoke preset.
 13. graft_entry.dryrun_multichip(8) held to one device and float64; on 2
     ranks the raw-ctcnet pair on data and seq meshes, TP at full width,
     the distributed decoders.
 14. pretrain_ctc (two seeded runs bit-equal, B1/B2), fast-WaveNet
     generation against the parallel forward, the autoregressive decoders
     and the label-sync beam against the CPU.
 15. NPZ shards through NPZQueueLoader into the bench step (launches, the
     trace naming the kernels), BayesOpt over train, the kmer experiments.
 16. The multi-tensor guard and optimizer at both train cells' trees: each
     stage against its plain version, the guard on injected values, updates.
 17. Bonito's transformer: the band kernels, B1/B2 at J = 2061, the model's
     steps and basecalls, the train entry point.
 18. Centred B4/B5 at train.raw_ctcnet's block shapes, and its step's
     launches.

Every failure raises, so the script exits non-zero; without CUDA it exits
non-zero before any check. It logs each phase's run time; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from wavenet_speech_tpu_torch import cli
from wavenet_speech_tpu_torch.data import npz_loader
from wavenet_speech_tpu_torch.data.common import Batch, MuLawQuantizer
from wavenet_speech_tpu_torch.data.npz_loader import NPZQueueLoader
from wavenet_speech_tpu_torch.data.raw_signal import RawSignalGenerator
from wavenet_speech_tpu_torch.data.gaussian_kmer import DEFAULT_KMER_MODEL, kmer_ids
from wavenet_speech_tpu_torch.data.hdf5 import ecoli_worker_fn
from wavenet_speech_tpu_torch.data.prefetch import FIELDS, batch_to_device
from wavenet_speech_tpu_torch.decoding import ctc_beam_device, streaming
from wavenet_speech_tpu_torch.decoding.alignment import batch_identity
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, beam_finalize, beam_init, beam_search_kernel, beam_search_ref, ctc_beam_search)
from wavenet_speech_tpu_torch.decoding.greedy import greedy_ctc_decode, labels2strings
from wavenet_speech_tpu_torch.decoding.labelsync import BeamSearchDecoder
from wavenet_speech_tpu_torch.decoding.streaming import StreamingBeamBatch
from wavenet_speech_tpu_torch.examples import gaussian_eval, kmer_experiments
from wavenet_speech_tpu_torch.facade import Dataset, Model
from wavenet_speech_tpu_torch.inference import (Basecaller, _chunk_grid, _default_margin,
                                                chunked_logits, chunked_logits_batch)
from wavenet_speech_tpu_torch.models import RawCTCNet, WaveNet, blocks, fast_wavenet
from wavenet_speech_tpu_torch.native import ctc_beam_search_native
from wavenet_speech_tpu_torch.ops import _build, ctc_scan, multi_tensor
from wavenet_speech_tpu_torch.ops import window_attention as wa
from wavenet_speech_tpu_torch.ops.activations import gated_activation
from wavenet_speech_tpu_torch.ops.conv import autopad, causal_conv1d
from wavenet_speech_tpu_torch.ops.ctc import (NEG, _extend_labels, _gather_ext,
                                              ctc_loss, ctc_loss_flat, ctc_loss_per_seq)
from wavenet_speech_tpu_torch.ops.ctc_scan import ctc_bwd, ctc_bwd_ref, ctc_fwd, ctc_fwd_ref
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref,
                                                      fused_gated_block_kernel_ref,
                                                      fused_gated_block_ref, tap_origin)
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch import graft_entry
from wavenet_speech_tpu_torch.parallel import (collectives, make_mesh, param_shardings,
                                               run_ranks, shard_batch, shard_params)
from wavenet_speech_tpu_torch.parallel.sharding import local_slices
from wavenet_speech_tpu_torch.training import (JointLoss, TrainState, build_optimizer,
                                               make_eval_step, make_joint_train_step,
                                               param_tree, trainer)
from wavenet_speech_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from wavenet_speech_tpu_torch.training import pretrain
from wavenet_speech_tpu_torch.training.diagnostics import dump_anomaly
from wavenet_speech_tpu_torch.training.pretrain import (build_encdec, build_posenc_encoder,
                                                        build_rnn_decoder_pair, pretrain_ctc)
from wavenet_speech_tpu_torch.training.trainer import (_forward_losses, all_finite,
                                                       all_reduce_grads, global_norm_safe,
                                                       make_ctc_train_step)
from wavenet_speech_tpu_torch.tools.bayes_opt import BayesOpt, cli_objective, set_config_path
from wavenet_speech_tpu_torch.utils import profiling
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map

SEED = 0
B, L = 8, 4505                       # bench.py:105-149 batch and read length
LEVELS, LABELS, POOL = 256, 5, 4
WAVENET_DILS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512] * 3
CLASSIFIER_DILS = [1, 2, 4, 8, 16, 32] * 3
BEAM_WIDTH = 7
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
# B5's dx at a centred block adds a float32 summation term: its sums (da =
# do out_w^T over 2C products, then dx over K*2C + C) taken in another order
# than the plain version's differ by at most 2 n 2^-24 times the sum of
# their terms' magnitudes (n = 2C + K*2C + C, the worst case of two
# recursive sums), and by 2^-16 of it more where a kernel splits dg into
# two planes (bf16 hi + lo, or TF32). In phase 7's length-aware step the
# last classifier blocks' dx cancels to ~1e-3 of those terms, where
# B4_ATOL x max|dx| sits below float32's own reordering (the float32 B5
# misses it there too); a tap read at a wrong row moves dx by about a
# third of the terms, far outside it. The causal holds keep their bounds.
DX_SPLIT = 2.0 ** -16
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
# bf16 (phase 6): the kernels and their plain versions round the same float32
# sums (taken in another order) to bf16, so an output may land one bf16 step
# apart: |kernel - plain| <= BF16_STEP * |plain| + the float32 term above
# (B4_ATOL, B5_WGRAD_ATOL x max|plain|); B4 also rounds act to bf16 before
# the 1x1 product, where a flipped rounding of one act value moves an output
# by one act step (<= 2^-8) times |out_w|: + 2 * 2^-8 * max|out_w|.
BF16 = torch.bfloat16
BF16_STEP = 2.0 ** -7
# At full depth the untrained stack turns a flipped bf16 rounding into a
# gradient change as large as the gradient (PERF.md), so the bf16 gradients
# and updates are held where the depth is cut to 3+2 blocks: within
# SENS_FACTOR x the bf16 cuDNN composite's distance from the plain
# versions', and within BF16_GRAD_RTOL, which zeroed causal-block gradients
# exceed. At 10+6 blocks the gaps are printed, not held: how they grow.
CUT_DEPTHS = ((([1, 2, 4], [1, 2]), True),
              (([1, 2, 4, 8, 16, 32, 64, 128, 256, 512], [1, 2, 4, 8, 16, 32]), False))
BF16_GRAD_RTOL = 0.1
CLI_CONFIG = Path(__file__).resolve().parent / "configs" / "ecoli_hdf5.json"
# the causal block at widths the kernels do not take as they are (C_in=6,
# C=10: zero-padded to 32, 32 in float32 and 8, 16 in bf16) and more taps
# than one pass of the backward's reduction takes (K=9): B, L, C_in, C, K, d
PAD_BLOCK = (2, 300, 6, 10, 9, 7)


def log(*a):
    print(*a, flush=True)


# the port's CUDA numerics (wavenet_speech_tpu_torch/utils/device.py), and
# torch's defaults, which main() sets before the port's first entry point
PORT_NUMERICS = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
                 "cudnn.deterministic": True, "cudnn.benchmark": False}
TORCH_DEFAULTS = {"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": False,
                  "cudnn.deterministic": False, "cudnn.benchmark": False}
_NUMERICS_FLAGS = {"cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
                   "cuda.matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
                   "cudnn.deterministic": (torch.backends.cudnn, "deterministic"),
                   "cudnn.benchmark": (torch.backends.cudnn, "benchmark")}


def numerics():
    return {k: getattr(obj, name) for k, (obj, name) in _NUMERICS_FLAGS.items()}


def check_numerics(where):
    if numerics() != PORT_NUMERICS:
        raise AssertionError(f"{where}: CUDA numerics {numerics()}, not the port's "
                             f"{PORT_NUMERICS}")


def cfg_full_width():
    return {"model": {
        "base": {"signal_dim": LEVELS, "entry_kwidth": 2, "kernel": 2,
                 "dilations": WAVENET_DILS},
        "classifier": {"kernel": 2, "dilations": CLASSIFIER_DILS,
                       "downsample": POOL, "num_labels": LABELS}}}


def scale_res_w(model):
    """Every block's res_w scaled by 1/sqrt(2), which keeps the residual
    stream's scale (see phase 4)."""
    with torch.no_grad():
        for blk in [*model.model_base.stack.blocks, model.model_ctc.input_block,
                    *model.model_ctc.stack.blocks]:
            blk.res_w.mul_(0.5 ** 0.5)
    return model


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


def cudnn_block(x, gw, gb, ow, ob, rw, rb, d, causal=True):
    """The fused block as a cuDNN conv + matmuls, causal or centred (padded
    as noncausal_conv1d pads): a yardstick the port never calls."""
    span = (gw.shape[0] - 1) * d
    left = span if causal else autopad(gw.shape[0], d)
    xp = F.pad(x.transpose(1, 2), (left, span - left))
    g = F.conv1d(xp, gw.permute(2, 1, 0), gb, dilation=d).transpose(1, 2)
    C = rw.shape[1]
    o = torch.matmul(gated_activation(g[..., :C], g[..., C:]), ow) + ob
    return o[..., :C] + torch.matmul(x, rw) + rb, o[..., C:]


def dx_sum_allowance(x, fw, d, dr, ds, causal):
    """The centred holds' float32 summation term for B5's dx (DX_SPLIT's
    comment), element by element: (2 n 2^-24 + DX_SPLIT) times |dresid|
    |res_w|^T plus each tap's |dg| |gate_w[k]|^T, where |dg| takes |do|
    |out_w|^T for |da| (which also bounds da's own rounding) times the gate
    derivatives, on the widened operands."""
    x, gw, gb, ow, _, rw, _ = (t.float() for t in (x, *fw))
    dr, ds = dr.float(), ds.float()
    K, C_in, C2 = gw.shape
    L, C = x.shape[1], C2 // 2
    h, R = (K - 1) * d, tap_origin(K, d, causal)
    xp = F.pad(x, (0, 0, h - R, R))
    g = gb + sum(xp[:, k * d: k * d + L] @ gw[k] for k in range(K))
    th, sg = torch.tanh(g[..., :C]), torch.sigmoid(g[..., C:])
    da = torch.cat([dr, ds], -1).abs() @ ow.abs().T
    dg = torch.cat([da * sg * (1.0 - th * th), da * th.abs() * sg * (1.0 - sg)], -1)
    dgp = F.pad(dg, (0, 0, R, h - R))
    m = dr.abs() @ rw.abs().T
    for k in range(K):
        s = (K - 1 - k) * d
        m = m + dgp[:, s: s + L] @ gw[k].abs().T
    return (2 * (C2 + K * C2 + C) * 2.0 ** -24 + DX_SPLIT) * m


def hold_b4(d, got, want):
    """B4's outputs within B4_RTOL |plain| + B4_ATOL max|plain|; returns
    (max abs error, max|plain|)."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        bad = ((g - w).abs() > B4_RTOL * w.abs() + B4_ATOL * scale).sum()
        if bad:
            raise AssertionError(f"B4 d={d}: {int(bad)} elements beyond tolerance; "
                                 f"max_abs_err {err:.3e}, max|plain| {scale:.3e}")
    return err, scale


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
        err, scale = hold_b4(d, got, want)
        lib_err = max(float((g - w).abs().max()) for g, w in zip(lib, want))
        rows.append(dict(d=d, err=err, lib_err=lib_err, scale=scale))
        x = want[0]
    for r in rows:
        log(f"  B4 d={r['d']:3d}  max|plain|={r['scale']:.3e} max_abs_err={r['err']:.3e} "
            f"(library's {r['lib_err']:.3e})")
    log(f"B4 fused_gated_block: 30 dilations within rtol {B4_RTOL}, atol {B4_ATOL} "
        f"x max|plain|; max_abs_err={max(r['err'] for r in rows):.3e}")


def beam_chained(lp, lengths, S, one):
    """Two calls, frames [0, T/2) and then [T/2, T) from the state the first
    returned, must give the bits of one call (``one``)."""
    kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
    T = lp.shape[1]
    t1 = T // 2
    mid = beam_search_kernel(lp[:, :t1], lengths, **kw)
    two = beam_search_kernel(lp[:, t1:], lengths, state=mid, t0=t1, **kw)
    if not all(torch.equal(x, y) for x, y in zip(two, one)):
        raise AssertionError("beam: two chained calls differ from one call")
    log(f"B6 chained: frames [0, {t1}) then [{t1}, {T}) from the returned state equal one "
        f"call bit for bit")


def phase_beam(lp, lengths, S):
    """B6 against its plain version on the real forward's log-probs."""
    kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
    state = beam_search_kernel(lp, lengths, **kw)
    got = beam_finalize(state)
    want = beam_finalize(beam_search_ref(lp, lengths, **kw))
    live, err = compare_beams(got, want, BEAM_WIDTH)
    beam_chained(lp, lengths, S, state)
    log(f"B6 ctc_beam: {live} live beam rows equal (prefixes, lengths, times), "
        f"max score error {err:.3e} (tolerance {BEAM_SCORE_ATOL}); "
        f"best length {int(want[1][0, 0])}")


def plain_versions():
    """Route the model and the beam through the kernels' plain versions."""
    stack = blocks_as(fused_gated_block_ref)
    beam = mock.patch.object(ctc_beam_device, "beam_search_kernel",
                             ctc_beam_device.beam_search_ref)
    return stack, beam


def blocks_as(fn):
    """Run the models' blocks, causal and centred, through fn instead of the
    kernels."""
    return mock.patch.object(blocks, "fused_gated_block", fn)


def block_launches(model, forwards, backwards=0, bf16=False):
    """The fused blocks' launch counts (graft_entry.launches' keys, zeros
    left out) when model runs `forwards` forward and `backwards` backward
    passes: B4 and B5 (bf16: their bf16 forms) once a ResidualBlock each,
    B4's launches of centred blocks counted again."""
    blks = [m for m in model.modules() if isinstance(m, blocks.ResidualBlock)]
    sfx = "_bf16" if bf16 else ""
    counts = {f"fused_gated_block{sfx}": len(blks) * forwards,
              f"fused_gated_block_bwd{sfx}": len(blks) * backwards,
              "fused_gated_block_centred": sum(not b.causal for b in blks) * forwards}
    return {k: v for k, v in counts.items() if v}


def cfg_block_launches(cfg, *args, **kwargs):
    """block_launches of the model a config builds (cli.build_from_config's
    model type; on the meta device)."""
    family = cfg.get("model", {}).get("type", "wavenet-ctc")
    return block_launches(Model(family, cfg, device="meta"), *args, **kwargs)


def add_counts(*counts):
    """Launch counts summed key by key."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


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


def phase_padded_block(dev):
    """The causal block at PAD_BLOCK's widths and taps: B4, B5, B4-bf16 and
    B5-bf16 each launched once (the wrapper pads the widths; the backward
    takes the taps in two passes) against their plain versions at the
    tolerances of phases 1, 5 and 6; each wrapper's count must show its
    launch (a CUDA tensor never falls back to the plain version)."""
    Bx, Lx, C_in, C, K, d = PAD_BLOCK
    g = torch.Generator().manual_seed(SEED + 6)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(dev)
    x, dr, ds = u(Bx, Lx, C_in), u(Bx, Lx, C), u(Bx, Lx, C)
    fw = (u(K, C_in, 2 * C) * 0.3, u(2 * C) * 0.1, u(C, 2 * C) * 0.3, u(2 * C) * 0.1,
          u(C_in, C) * 0.3, u(C) * 0.1)
    gw, gb, ow, _, rw, _ = fw
    reset_counts()
    b4_err, _ = hold_b4(d, fused_gated_block(x, *fw, d), fused_gated_block_ref(x, *fw, d))
    b5_errs, _ = hold_b5(d, fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d),
                         fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d))
    bf = lambda t: t.to(BF16)
    f16_err, b16_errs = check_bf16_block(bf(x), tuple(bf(t) for t in fw), d, bf(dr), bf(ds))
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    want = {"fused_gated_block": 1, "fused_gated_block_bwd": 1, "fused_gated_block_bf16": 1,
            "fused_gated_block_bwd_bf16": 1}
    if counts != want:
        raise AssertionError(f"padded block: launches {counts}, expected {want}")
    log(f"padded block (B={Bx}, L={Lx}, C_in={C_in}, C={C}, K={K}, d={d}): B4, B5, B4-bf16, "
        f"B5-bf16 each launched once, within phases 1/5/6's tolerances; max_abs_err B4 "
        f"{b4_err:.3e}, B5 {max(b5_errs):.3e}, B4-bf16 {f16_err:.3e}, B5-bf16 "
        f"{max(b16_errs):.3e}")


# ---- 5. training --------------------------------------------------------------

def ctc_plain():
    """Run the CTC recursion through B1's and B2's plain versions."""
    return mock.patch.multiple(ctc_scan, ctc_fwd=ctc_fwd_ref, ctc_bwd=ctc_bwd_ref)


reset_counts, read_counts = graft_entry.reset_launches, graft_entry.launches


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
    """||a - b|| / ||b|| over lists of tensors, by the overflow-proof norm
    (its plain version: the lists may be float64)."""
    with plain_multi_tensor():
        return float(global_norm_safe([x - y for x, y in zip(a, b)])
                     / global_norm_safe(list(b)))


def grad_sets(model, batch, grads):
    """The gradients on the kernels, on their plain versions and on the
    cuDNN composite (the last two with the plain CTC)."""
    g_k = grads(model, batch)
    with blocks_as(fused_gated_block_ref), ctc_plain():
        g_p = grads(model, batch)
    with blocks_as(cudnn_block), ctc_plain():
        g_c = grads(model, batch)
    return g_k, g_p, g_c


def phase_grad_ratio(model, batch, label, grads=loss_grads):
    """The kernel step's gradients no farther from the plain step's than
    SENS_FACTOR x the cuDNN-composite step's (as phase 3 for logits).
    Returns the three sets of gradients."""
    g_k, g_p, g_c = grad_sets(model, batch, grads)
    k, c = rel_err(g_k, g_p), rel_err(g_c, g_p)
    log(f"{label}, gradients of the joint loss: ||g - g_plain|| / ||g_plain|| kernel "
        f"{k:.3e}, cuDNN composite {c:.3e}, ratio {k / c:.3f} (bound {SENS_FACTOR}); "
        f"||g_plain|| {float(global_norm_safe(list(g_p))):.3e}")
    if not k <= SENS_FACTOR * c:
        raise AssertionError(f"{label}: kernel gradients' error {k:.3e} > "
                             f"{SENS_FACTOR} x the cuDNN step's {c:.3e}")
    return g_k, g_p, g_c


def record_blocks(rec):
    """The models' blocks, causal and centred, through their plain version,
    each block's input, weights, dilation, outputs and kind appended to
    rec."""
    def recorder(x, *w_and_d, causal=True):
        r, s = fused_gated_block_ref(x, *w_and_d, causal)
        rec.append((x.detach().contiguous(), [t.detach().contiguous() for t in w_and_d[:-1]],
                    w_and_d[-1], r, s, causal))
        return r, s

    return blocks_as(recorder)


def recorded_blocks(rec, objective):
    """Each block record_blocks recorded as (x, weights, dilation, dresid,
    dskip, causal), the cotangents those of the scalar objective, made
    contiguous as the autograd Function makes them (a pool's gradient is
    strided)."""
    outs = [t for *_, r, s, _ in rec for t in (r, s)]
    cots = [t.contiguous() for t in torch.autograd.grad(objective, outs, allow_unused=True,
                                                        materialize_grads=True)]
    return [(x, fw, d, cots[2 * i], cots[2 * i + 1], causal)
            for i, (x, fw, d, _, _, causal) in enumerate(rec)]


def bwd_weights(fw):
    """B5's weights (gate_w, gate_b, out_w, res_w) of the forward's six."""
    return fw[0], fw[1], fw[2], fw[4]


def capture_backward(model, batch):
    """The plain step's forward and backward: each block's input, weights,
    output cotangents and kind (recorded_blocks), and the CTC's extended
    log-probs and cotangent."""
    rec = []
    with record_blocks(rec), ctc_plain():
        loss, logits = joint_loss(model, batch)
        blocks_io = recorded_blocks(rec, loss)
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


def hold_b5(d, got, want, dx_extra=0.0):
    """B5's outputs within B4_RTOL |plain| + atol max|plain| (B4_ATOL for
    dx, plus dx_extra, elementwise; B5_WGRAD_ATOL for the weight and bias
    gradients); returns (max abs errors, max|plain|s), one an output."""
    errs, scales = [], []
    for name, g, p in zip(B5_OUTPUTS, got, want):
        scale = float(p.abs().max())
        err = float((g - p).abs().max())
        atol = B4_ATOL if name == "dx" else B5_WGRAD_ATOL
        extra = dx_extra if name == "dx" else 0.0
        bad = int(((g - p).abs() > B4_RTOL * p.abs() + atol * scale + extra).sum())
        if bad:
            raise AssertionError(f"B5 d={d} {name}: {bad} elements beyond tolerance; "
                                 f"max_abs_err {err:.3e}, max|plain| {scale:.3e}")
        errs.append(err)
        scales.append(scale)
    return errs, scales


def phase_fused_block_bwd(blocks_io):
    """B5 against its plain version at each of the 30 causal dilations, on
    the inputs and cotangents of the real backward; a second call on the
    same inputs must give the same bits in all seven outputs. Then B4 and
    B5 at the classifier's centred blocks (hold_centred)."""
    rows = []
    causal_io = [io for io in blocks_io if io[5]]
    for x, fw, d, dr, ds, _ in causal_io:
        w = bwd_weights(fw)
        got = fused_gated_block_bwd(x, *w, dr, ds, d)
        again = fused_gated_block_bwd(x, *w, dr, ds, d)
        want = fused_gated_block_bwd_ref(x, *w, dr, ds, d)
        lib = cudnn_block_bwd(x, w, d, dr, ds)()
        torch.cuda.synchronize()
        for name, a, b in zip(B5_OUTPUTS, got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"B5 d={d} {name}: two calls on the same inputs differ")
        errs, scales = hold_b5(d, got, want)
        lib_errs = [float((c - p).abs().max()) for c, p in zip(lib, want)]
        rows.append(dict(d=d, errs=errs, lib_errs=lib_errs, scales=scales))
    for r in rows:
        log(f"  B5 d={r['d']:3d} max_abs_err/max|plain| "
            + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, e, s in zip(B5_OUTPUTS, r["errs"],
                                                                 r["scales"]))
            + f" (library's max {max(r['lib_errs']):.2e})")
    worst = [max(r["errs"][i] for r in rows) for i in range(len(B5_OUTPUTS))]
    worst_lib = [max(r["lib_errs"][i] for r in rows) for i in range(len(B5_OUTPUTS))]
    log(f"B5 fused_gated_block_bwd: {len(rows)} dilations within rtol {B4_RTOL}, atol {B4_ATOL} "
        f"(dx) / {B5_WGRAD_ATOL} (weights, biases) x max|plain|, two calls bit-equal; max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in zip(B5_OUTPUTS, worst))
        + "; cuDNN-composite autograd's " + " ".join(f"{k}={e:.3e}" for k, e in
                                                      zip(B5_OUTPUTS, worst_lib)))
    hold_centred(blocks_io, "phase 5")


def check_close(name, got, want, rtol, atol):
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: beyond rtol {rtol}, atol {atol}; max_abs_err {err:.3e}")
    return err


def phase_ctc(lp, skip, logits, batch, lens=None):
    """B1 and B2 against their plain versions on the real step's extended
    log-probs and logit lengths (default every frame), the cotangent
    d loss / d ll = -1/T of JointLoss; the port's CTC against F.ctc_loss
    (loss and gradient), the yardstick."""
    T, Bx, J = lp.shape
    if lens is None:
        lens = torch.full((Bx,), T, dtype=torch.int32, device=lp.device)
    lab, labels = batch["label_lengths"], batch["labels"]
    cot = torch.full((Bx,), -1.0 / T, device=lp.device)
    got = ctc_fwd(lp, skip, lens, lab)
    want = ctc_fwd_ref(lp, skip, lens, lab)
    err1 = max(check_close("B1 ll", got[0], want[0], CTC_RTOL, CTC_ATOL),
               check_close("B1 alphas", got[1], want[1], CTC_RTOL, CTC_ATOL))
    gg, _ = ctc_bwd(lp, want[1], skip, lens, lab, want[0], cot)
    gw, _ = ctc_bwd_ref(lp, want[1], skip, lens, lab, want[0], cot)
    err2 = check_close("B2 grad", gg, gw, CTC_GRAD_RTOL, CTC_GRAD_ATOL)
    log(f"B1 ctc_alpha, B2 ctc_beta: T={T} B={Bx} J={J}; max_abs_err {err1:.3e}, {err2:.3e}")

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
    expect = {**block_launches(model, 1, 1), "ctc_alpha": 1, "ctc_beta": 1}
    state, hist, launches = train_steps(step, state0, batch, expect)
    for i, m in enumerate(hist):
        log(f"train step {i + 1} (kernels): " + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    log(f"train steps: launches per step {launches}")
    with blocks_as(fused_gated_block_ref), ctc_plain():
        pstate, phist, plaunch = train_steps(step, state0, batch)
    if plaunch:
        raise AssertionError(f"the plain steps launched kernels: {plaunch}")
    with blocks_as(cudnn_block), ctc_plain():
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


def run_training(dev):
    batch = bench_batch(dev)
    model = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    phase_grad_ratio(model, batch, "port init")
    scale_res_w(model)         # the stream's scale kept, as in phase 4
    phase_grad_ratio(model, batch, "scaled res_w")
    blocks_io, logits, lp_ext, skip = capture_backward(model, batch)
    phase_fused_block_bwd(blocks_io)
    del blocks_io
    phase_ctc(lp_ext, skip, logits, batch)
    phase_train_steps(model, batch)
    phase_train_small(dev)


# ---- 6. bf16 training ---------------------------------------------------------

def step_grads(dtype, loss=None):
    """Gradients of the train step's objective (loss, default the joint)
    with respect to the float32 params, the models run in dtype through the
    step's own cast."""
    loss = loss or JointLoss("joint")

    def grads(model, batch):
        params = model.params()
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        total, _, _ = _forward_losses(model.model_base, model.model_ctc, loss, params, batch,
                                      None, dtype)
        return torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    return grads


def capture_blocks(model, batch, dtype, loss=None, logit_length_fn=None, mesh=None):
    """The plain forward and backward of the train step's objective, the
    models run in dtype through the step's cast (with a mesh, on this
    rank's shard, every rank calling): each block's input, weights,
    dilation, output cotangents and kind (recorded_blocks)."""
    rec = []
    params = model.params()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with record_blocks(rec), ctc_plain():
        total, _, _ = _forward_losses(model.model_base, model.model_ctc,
                                      loss or JointLoss("joint"), params, batch,
                                      logit_length_fn, dtype, mesh)
        return recorded_blocks(rec, total)


def hold_f32_block(x, fw, d, dr, ds, causal=True):
    """B4 and B5 (float32) against the kernels' arithmetic in plain PyTorch
    (fused_gated_block_kernel_ref, fused_gated_block_bwd_ref) on one
    block's inputs and cotangents, within phases 1 and 5's tolerances.
    Returns (B4's max abs error, B5's per output)."""
    w, where = bwd_weights(fw), d if causal else f"{d} centred"
    b4_err, _ = hold_b4(where, fused_gated_block(x, *fw, d, causal),
                        fused_gated_block_kernel_ref(x, *fw, d, causal))
    b5_errs, _ = hold_b5(where, fused_gated_block_bwd(x, *w, dr, ds, d, causal),
                         fused_gated_block_bwd_ref(x, *w, dr, ds, d, causal),
                         0.0 if causal else dx_sum_allowance(x, fw, d, dr, ds, causal))
    return b4_err, b5_errs


def hold_blocks(blocks_io):
    """B4 and B5, or their bf16 forms on bf16 blocks, at each captured
    block (recorded_blocks), causal or centred (hold_f32_block,
    check_bf16_block); returns their max abs errors."""
    f_err = b_err = 0.0
    with torch.no_grad():
        for io in blocks_io:
            f, b = (check_bf16_block if io[0].dtype == BF16 else hold_f32_block)(*io)
            f_err, b_err = max(f_err, f), max(b_err, *b)
    return f_err, b_err


def hold_centred(blocks_io, label):
    """hold_blocks at the centred blocks of blocks_io, logged; there must be
    some."""
    centred = [io for io in blocks_io if not io[5]]
    if not centred:
        raise AssertionError(f"{label}: no centred block was captured")
    f_err, b_err = hold_blocks(centred)
    x, C = centred[0][0], centred[0][1][4].shape[1]
    form = "-bf16" if x.dtype == BF16 else ""
    log(f"{label}: B4{form} and B5{form} at the {len(centred)} centred blocks (B={x.shape[0]}, "
        f"L={x.shape[1]}, C={C}, d={sorted({io[2] for io in centred})}) against the kernels' "
        f"arithmetic within {'phase 6' if form else 'phases 1 and 5'}'s tolerances; "
        f"max_abs_err B4 {f_err:.3e}, B5 {b_err:.3e}")
    return f_err, b_err


def check_bf16(name, d, got, want, extra):
    """|got - want| <= BF16_STEP |want| + extra elementwise; returns the max
    absolute error."""
    diff = (got.float() - want.float()).abs()
    bad = int((diff > BF16_STEP * want.float().abs() + extra).sum())
    if bad:
        raise AssertionError(f"{name} d={d}: {bad} elements beyond tolerance; max_abs_err "
                             f"{float(diff.max()):.3e}, max|plain| {float(want.abs().max()):.3e}")
    return float(diff.max())


def check_bf16_block(x, fw, d, dr, ds, causal=True):
    """B4-bf16 and B5-bf16 against the bf16 kernels' arithmetic in plain
    PyTorch (fused_gated_block_kernel_ref, fused_gated_block_bwd_ref) on one
    block's inputs and cotangents: bf16 out, each output within the bf16
    tolerance. Returns (B4's max abs error, B5's per output)."""
    gw, gb, ow, ob, rw, rb = fw
    where = d if causal else f"{d} centred"
    got = fused_gated_block(x, *fw, d, causal=causal)
    want = fused_gated_block_kernel_ref(x, *fw, d, causal)
    if any(t.dtype != BF16 for t in got):
        raise AssertionError(f"B4-bf16 d={where}: outputs {[t.dtype for t in got]}")
    f_extra = B4_ATOL * max(float(w.abs().max()) for w in want) + \
        2 * 2.0 ** -8 * float(ow.abs().max())
    f_err = max(check_bf16("B4-bf16", where, g, w, f_extra) for g, w in zip(got, want))
    gotb = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d, causal)
    wantb = fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d, causal)
    if any(t.dtype != BF16 for t in gotb):
        raise AssertionError(f"B5-bf16 d={where}: outputs {[t.dtype for t in gotb]}")
    dx_extra = 0.0 if causal else dx_sum_allowance(x, fw, d, dr, ds, causal)
    b_errs = [check_bf16(f"B5-bf16 {n}", where, g, w, (B4_ATOL if n == "dx" else B5_WGRAD_ATOL)
                         * float(w.float().abs().max()) + (dx_extra if n == "dx" else 0.0))
              for n, g, w in zip(B5_OUTPUTS, gotb, wantb)]
    return f_err, b_errs


def phase_bf16_kernels(blocks_io):
    """B4-bf16 and B5-bf16 against their plain bf16 versions at each of the
    30 dilations, on the inputs and cotangents of the bf16 forward and
    backward; then both at the classifier's centred blocks (hold_centred)."""
    rows = []
    for x, fw, d, dr, ds, _ in [io for io in blocks_io if io[5]]:
        f_err, b_errs = check_bf16_block(x, fw, d, dr, ds)
        rows.append(dict(d=d, f_err=f_err, b_errs=b_errs))
    for name, err in (("B4-bf16 fused_gated_block_bf16", max(r["f_err"] for r in rows)),
                      ("B5-bf16 fused_gated_block_bwd_bf16",
                       max(max(r["b_errs"]) for r in rows))):
        log(f"{name}: 30 dilations within {BF16_STEP} x |plain| + the float32 term; "
            f"max_abs_err={err:.3e}")
    for r in rows:
        log(f"  bf16 d={r['d']:3d} B4 err {r['f_err']:.2e} | B5 err "
            + " ".join(f"{k}={e:.2e}" for k, e in zip(B5_OUTPUTS, r["b_errs"])))
    hold_centred(blocks_io, "phase 6")


def bf16_steps(model, batch):
    """3 bf16 joint steps on the kernels (each step launches B4-bf16 and
    B5-bf16 once a block, B1 and B2 once, no float32 block; params
    and optimizer state stay float32), then on the plain versions and on
    the bf16 cuDNN composite from the same state. Returns (the kernels'
    metrics, launches, the updates dp = p_3 - p_0 of the three runs)."""
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 compute_dtype=BF16)
    state0 = TrainState.create(model.params(), tx)
    expect = {**block_launches(model, 1, 1, bf16=True), "ctc_alpha": 1, "ctc_beta": 1}
    state, hist, launches = train_steps(step, state0, batch, expect)
    if any(t.dtype != torch.float32 for t in tree_leaves((state.params, state.opt_state))
           if t.is_floating_point()):
        raise AssertionError("bf16 steps: params or optimizer state not float32")
    with blocks_as(fused_gated_block_ref), ctc_plain():
        pstate, _, plaunch = train_steps(step, state0, batch)
    if plaunch:
        raise AssertionError(f"the plain bf16 steps launched kernels: {plaunch}")
    with blocks_as(cudnn_block), ctc_plain():
        cstate, _, _ = train_steps(step, state0, batch)
    p0 = tree_leaves(state0.params)
    updates = [[a - b for a, b in zip(tree_leaves(s.params), p0)]
               for s in (state, pstate, cstate)]
    return hist, launches, updates


def phase_train_steps_bf16(model, batch):
    """The bench model's 3 bf16 steps: launches, float32 state, updates to
    the cuDNN yardstick, and the bf16 losses against the float32 losses."""
    state0_params = model.params()
    hist, launches, (dk, dp, dc) = bf16_steps(model, batch)
    for i, m in enumerate(hist):
        log(f"bf16 train step {i + 1} (kernels): "
            + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    log(f"bf16 train steps: launches per step {launches}; params stay float32")
    upd_k, upd_c = rel_err(dk, dp), rel_err(dc, dp)
    log(f"3 bf16 steps against the plain versions' 3: updates ||dp - dp_p|| / ||dp_p|| "
        f"kernels {upd_k:.3e}, bf16 cuDNN composite {upd_c:.3e}, ratio {upd_k / upd_c:.3f} "
        f"(bound {SENS_FACTOR})")
    if not upd_k <= SENS_FACTOR * upd_c:
        raise AssertionError("the bf16 kernel steps' updates differ from the plain steps' "
                             "beyond the cuDNN yardstick")
    # the bf16 objective against the float32 one at the same params
    f32 = make_eval_step(model.model_base, model.model_ctc)(state0_params, batch)
    b16 = make_eval_step(model.model_base, model.model_ctc, compute_dtype=BF16)(
        state0_params, batch)
    log("bf16 against float32 losses at the same params: " + " ".join(
        f"{k} {float(b16[k]):.6g} vs {float(f32[k]):.6g} (rel "
        f"{abs(float(b16[k]) - float(f32[k])) / abs(float(f32[k])):.2e})" for k in f32))


def model_parts(model):
    """The params' leaf indices by part of the model: the WaveNet's causal
    blocks by thirds of the stack (B5 writes their gradients), the rest of
    the WaveNet, the classifier."""
    n = len(model.model_base.stack.blocks)
    parts = {}
    for i, name in enumerate(f"{top}.{k}" for top, sub in model.params().items() for k in sub):
        if name.startswith("base.stack.blocks."):
            third = 3 * int(name.split(".")[3]) // n
            key = f"causal blocks {third * n // 3 + 1}-{(third + 1) * n // 3}"
        else:
            key = "WaveNet rest" if name.startswith("base.") else "classifier"
        parts.setdefault(key, []).append(i)
    return parts


def gap_by_part(model, g_k, g_p, g_c):
    """||g - g_plain|| / ||g_plain|| of the kernels and of the cuDNN
    composite over each part's leaves that the loss reaches, and the part's
    share ||g_plain[part]|| / ||g_plain||."""
    total = float(global_norm_safe(list(g_p)))
    out = []
    for part, idx in model_parts(model).items():
        pick = lambda g: [g[i] for i in idx]
        if float(global_norm_safe(pick(g_p))) == 0.0:
            continue
        out.append(f"{part} {rel_err(pick(g_k), pick(g_p)):.3e}/"
                   f"{rel_err(pick(g_c), pick(g_p)):.3e} "
                   f"(share {float(global_norm_safe(pick(g_p))) / total:.3f})")
    return "; ".join(out)


LOSS_TERMS = (("XE alone", JointLoss("joint", ctc_weight=0.0)), ("CTC alone", JointLoss("ctc")))


def phase_bf16_grads(model, batch, label):
    """At full depth the bf16 gradients are held to the cuDNN yardstick
    only (phase_grad_ratio); what carries their gap: the joint's by part of
    the model, and each loss term's alone."""
    g = phase_grad_ratio(model, batch, f"bf16, {label}", step_grads(BF16))
    log(f"bf16, {label}, joint gap by part (kernel/cuDNN): {gap_by_part(model, *g)}")
    for term, loss in LOSS_TERMS:
        g_k, g_p, g_c = grad_sets(model, batch, step_grads(BF16, loss))
        log(f"bf16, {label}, {term}: ||g - g_plain|| / ||g_plain|| kernel "
            f"{rel_err(g_k, g_p):.3e}, cuDNN composite {rel_err(g_c, g_p):.3e}; by part "
            f"{gap_by_part(model, g_k, g_p, g_c)}")


def phase_bf16_cut_depth(dev, batch, dils, hold):
    """The bench model's width and batch at a depth cut to dils = (WaveNet,
    classifier dilations), initialised from the seed: the kernel bf16
    step's gradients and the updates of 3 bf16 steps against the plain bf16
    versions', over all leaves and over the causal blocks' alone (B5's
    outputs), beside the bf16 cuDNN composite's. With hold, each must be
    within min(SENS_FACTOR x the cuDNN composite's, BF16_GRAD_RTOL), and a
    control with the causal blocks' gradients (updates) zeroed must fail
    that bound."""
    cfg = cfg_full_width()
    cfg["model"]["base"]["dilations"], cfg["model"]["classifier"]["dilations"] = dils
    model = Model("wavenet-ctc", cfg, device=dev).init(SEED)
    label = f"bf16, depth cut to {len(dils[0])}+{len(dils[1])} blocks"
    causal = {i for part, idx in model_parts(model).items() if part.startswith("causal")
              for i in idx}
    g_k, g_p, g_c = grad_sets(model, batch, step_grads(BF16))
    _, launches, (dk, dp, dc) = bf16_steps(model, batch)
    within = lambda k, c: k <= min(SENS_FACTOR * c, BF16_GRAD_RTOL)
    problems, rows = [], []
    for what, (a_k, a_p, a_c) in (("gradients", (g_k, g_p, g_c)), ("updates", (dk, dp, dc))):
        for leaves, idx in (("all leaves", range(len(a_p))), ("causal blocks", sorted(causal))):
            pick = lambda g: [g[i] for i in idx]
            k, c = rel_err(pick(a_k), pick(a_p)), rel_err(pick(a_c), pick(a_p))
            control = rel_err([0 * a_k[i] if i in causal else a_k[i] for i in idx], pick(a_p))
            rows.append(f"{what} over {leaves}: kernel {k:.3e}, cuDNN composite {c:.3e}, "
                        f"control {control:.3e}")
            if hold and not within(k, c):
                problems.append(f"{what} over {leaves}: kernel {k:.3e} beyond the bound")
            if hold and within(control, c):
                problems.append(f"{what} over {leaves}: the zeroed control {control:.3e} passes")
    log(f"{label}: ||x - x_plain|| / ||x_plain||"
        + (f" (bound min({SENS_FACTOR} x cuDNN's, {BF16_GRAD_RTOL}); control: the causal "
           f"blocks' share zeroed, must fail)" if hold else " (not held)")
        + ": " + "; ".join(rows) + f"; gradient gap by part (kernel/cuDNN): "
        f"{gap_by_part(model, g_k, g_p, g_c)}; launches a step {launches}")
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))


def run_training_bf16(dev):
    batch = bench_batch(dev)
    model = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    phase_bf16_grads(model, batch, "port init")
    scale_res_w(model)         # the stream's scale kept, as in phase 4
    phase_bf16_grads(model, batch, "scaled res_w")
    blocks_io = capture_blocks(model, batch, BF16)
    phase_bf16_kernels(blocks_io)
    del blocks_io
    phase_train_steps_bf16(model, batch)
    for dils, hold in CUT_DEPTHS:
        phase_bf16_cut_depth(dev, batch, dils, hold)


# ---- 7. the train entry point -------------------------------------------------

def read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def phase_train_cli(dev):
    """cli.train_with_result on configs/ecoli_hdf5.json's model and training
    block (pore data, 20 steps), twice on one run directory. The pore
    generator draws 10 samples a base, as the hdf5 reads the config is
    padded for (1216 samples for 120 labels): at its default 4, a third of
    a read's frames after the classifier's pool of 3 leave some label
    sequences no CTC alignment (a loss of ~7e27 in the JAX CLI and the
    port alike)."""
    cfg = json.loads(CLI_CONFIG.read_text())
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    cfg["training"].update(datatype="pore", min_sample_length=90, max_sample_length=110,
                           upsampling=10, save_dir=str(run_dir), max_iters=20,
                           print_every=10, save_every=10, async_checkpoint=True)
    try:
        for run, (start, end) in enumerate(((0, 20), (20, 40)), 1):
            logged = len(read_jsonl(run_dir / "logs" / "metrics.jsonl")) if run > 1 else 0
            reset_counts()
            result = cli.train_with_result(cfg, dev)
            torch.cuda.synchronize()
            run_counts = read_counts()
            lines = read_jsonl(run_dir / "logs" / "metrics.jsonl")[logged:]
            steps, valid = end - start, len(lines)     # one validation forward a print
            messages = (run_dir / "logs" / "messages.log").read_text()
            ckpts = sorted(int(p.name) for p in (run_dir / "ckpts").iterdir() if p.name.isdigit())
            want = {"fused_gated_block": 0, "fused_gated_block_bwd": 0,
                    "fused_gated_block_centred": 0,
                    **cfg_block_launches(cfg, steps + valid, steps, bf16=True)}
            got = {k: run_counts[k] for k in want}
            losses = [v for l in lines for v in (l["train_loss"], l["valid_loss"])]
            problems = [what for what, bad in (
                (f"steps {result['steps']} != {end}", result["steps"] != end),
                (f"launches {got} != {want}", got != want),
                (f"non-finite losses {losses}", not all(map(math.isfinite, losses))),
                (f"{valid} log lines", valid != 2),
                (f"checkpoints {ckpts}", ckpts != list(range(10, end + 1, 10))),
                ("no training.log", not (run_dir / "logs" / "training.log").is_file()),
                ("did not resume at step 20",
                 run > 1 and f"resumed from {run_dir}/ckpts/ @ step 20" not in messages))
                if bad]
            if problems:
                raise AssertionError(f"train entry point, run {run}: " + "; ".join(problems))
            log(f"train entry point run {run}: steps {start + 1}-{end}; losses "
                + ", ".join(f"step {l['step']} train {l['train_loss']:.4f} valid "
                            f"{l['valid_loss']:.4f}" for l in lines)
                + f"; launches {got}; checkpoints {ckpts}")
        cli_kernels(cfg, dev)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def check_cli_kernels(model, batch, t):
    """B4-bf16 and B5-bf16 against their plain versions at each of the train
    loop's blocks, on the inputs and cotangents of one bf16 step's objective
    (the config's loss, length-aware logit lengths) at its own shape."""
    fn = model.output_length if t.get("length_aware_ctc") else None
    blocks_io = capture_blocks(model, batch, BF16, JointLoss(t.get("loss", "joint")), fn)
    f_err, b_err = hold_blocks(blocks_io)
    x = blocks_io[0][0]
    log(f"train entry point: B4-bf16 and B5-bf16 at its {len(blocks_io)} blocks "
        f"({sum(not io[5] for io in blocks_io)} centred; B={x.shape[0]}, "
        f"L={sorted({io[0].shape[1] for io in blocks_io})}, "
        f"d={sorted({io[2] for io in blocks_io})}) within "
        f"{BF16_STEP} x |plain| + the float32 term; max_abs_err B4 {f_err:.3e}, B5 {b_err:.3e}")


def cli_kernels(cfg, dev):
    """check_cli_kernels on the loop's model (cli.build_from_config) and
    the tenth batch of its validation stream."""
    ds, model, _, _, _, t = cli.build_from_config(copy.deepcopy(cfg), dev)
    b = [ds.fetch("valid") for _ in range(10)][-1]
    check_cli_kernels(model, batch_to_device(b, dev), t)


# ---- 8. DP and SP over torch.distributed ---------------------------------------

SP_RANKS = 2
SP_L = 4608                  # the bench reads padded to a multiple of seq x pool x 2
SP_CUT = ([1, 2, 4], [1, 2])  # (b): the depth cut to 3+2 blocks
# (b): SP against the single-device kernel step at the cut depth: the same
# sums in another order (halo windows, shorter shards, a two-term
# all-reduce), which the cut stack barely amplifies
SP_LOSS_RTOL, SP_LEAF_RTOL = 1e-5, 1e-4
SP_FULL_LOSS_RTOL = 1e-4     # (c): full depth, res_w scaled
DP_HELD_BLOCKS = 10          # (d): B4/B5 held on the DP reads at one cycle


def logit_frames(signal_lengths):
    """The length-aware mode's logit lengths (the classifier's pool)."""
    return signal_lengths // POOL


def sp_batch(dev):
    """The bench batch (bench_batch) padded with zero frames to SP_L, its
    signal_lengths L: 1126 live logit frames of 1152."""
    b = bench_batch(dev)
    return {**b, "signal": F.pad(b["signal"], (0, 0, 0, SP_L - L))}


def sp_model(dev, dils=None):
    """The bench model from the seed (the same weights in every process),
    res_w scaled as in phase 4; dils = (WaveNet, classifier) dilations cut
    the depth."""
    cfg = cfg_full_width()
    if dils is not None:
        cfg["model"]["base"]["dilations"], cfg["model"]["classifier"]["dilations"] = dils
    return scale_res_w(Model("wavenet-ctc", cfg, device=dev).init(SEED))


def objective_grads(model, batch, mesh=None):
    """The train step's objective (joint, length-aware) and its gradients,
    on one device or, with a mesh, on this rank's shard with the gradients
    summed over the ranks, as the step computes them."""
    params = model.params()
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    total, _, _ = _forward_losses(model.model_base, model.model_ctc, JointLoss("joint"),
                                  params, batch, logit_frames, None, mesh)
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    return float(total.detach()), [g.detach() for g in all_reduce_grads(list(grads), mesh)]


class Recorder:
    """fn, with each call's (args, outputs) appended to calls. Its
    attributes are fn's, so fn's launch counts stay right while the
    recorder stands in its place."""

    def __init__(self, fn, calls):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "calls", calls)

    def __call__(self, *args):
        out = self.fn(*args)
        detach = lambda ts: tuple(t.detach() if torch.is_tensor(t) else t for t in ts)
        self.calls.append((detach(args), detach(out)))
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


@contextlib.contextmanager
def record_ctc():
    """Record every ctc_fwd / ctc_bwd call (under SP B3's, with the carry;
    else B1's and B2's): (args, outputs)."""
    rec = {"fwd": [], "bwd": []}
    with mock.patch.multiple(ctc_scan, ctc_fwd=Recorder(ctc_fwd, rec["fwd"]),
                             ctc_bwd=Recorder(ctc_bwd, rec["bwd"])):
        yield rec


def check_ctc(rec, name):
    """(a) on this rank: the first step's CTC calls (B3: with the carry
    they received and their t_offset; B1/B2 under DP) against the plain
    loops on the same inputs."""
    (fa, (ll, alphas, a_out)), (ba, (grad, lpb_out)) = rec["fwd"][0], rec["bwd"][0]
    want, wantb = ctc_fwd_ref(*fa), ctc_bwd_ref(*ba)
    err_f = max(check_close(f"{name}-fwd {n}", g, w, CTC_RTOL, CTC_ATOL)
                for n, g, w in zip(("ll", "alphas", "alpha_out"), (ll, alphas, a_out), want))
    err_b = max(check_close(f"{name}-bwd grad", grad, wantb[0], CTC_GRAD_RTOL, CTC_GRAD_ATOL),
                check_close(f"{name}-bwd lpb_out", lpb_out, wantb[1], CTC_RTOL, CTC_ATOL))
    out = {"fwd": err_f, "bwd": err_b}
    if len(fa) > 5:   # B3: for the chain check against B1/B2 on the whole sequence
        out["chain"] = dict(lp=fa[0], skipadd=fa[1], lens=fa[2], lab=fa[3], ll=ba[5], cot=ba[6],
                            grad=grad, t_offset=fa[5],
                            alpha_in_live=bool((fa[4] > NEG / 2).any()))
    return out


def check_blocks(blocks_io):
    """B4 and B5 against the kernels' arithmetic at each block, causal and
    centred, of the objective on this rank (SP: the [halo | shard | halo]
    window; DP: the rank's reads), within phase 1's and phase 5's
    tolerances (hold_f32_block)."""
    b4_err, b5_err = 0.0, [0.0] * len(B5_OUTPUTS)
    for io in blocks_io:
        f, errs = hold_f32_block(*io)
        b4_err, b5_err = max(b4_err, f), [max(a, b) for a, b in zip(b5_err, errs)]
    x = blocks_io[0][0]
    return dict(b4_err=b4_err, b5_err=b5_err, n=len(blocks_io), B=x.shape[0],
                L=sorted({io[0].shape[1] for io in blocks_io}),
                centred=sum(not io[5] for io in blocks_io))


def log_blocks(label, r):
    """One rank's check_blocks result."""
    log(f"{label}: B4 and B5 at its {r['n']} blocks ({r['centred']} centred; B={r['B']}, "
        f"L={r['L'][0]}.."
        f"{r['L'][-1]}) within rtol {B4_RTOL}, atol {B4_ATOL} / {B5_WGRAD_ATOL} x max|plain|; "
        f"max_abs_err B4 {r['b4_err']:.3e}, B5 "
        + " ".join(f"{k}={e:.2e}" for k, e in zip(B5_OUTPUTS, r["b5_err"])))


def sp_rank(device):
    """One rank of phase 8 (module-level: run_ranks spawns it). SP on a
    (data=1, seq=2) mesh: (b) the cut-depth gradients, (c) the full-depth
    gradients, B4/B5 against their plain versions on the halo windows, the
    main path (3 SP train steps, launches counted, B3's calls recorded),
    (a) B3 against its plain version; then DP on a (data=2,
    seq=1) mesh: B4/B5 against their plain versions on the rank's reads,
    (d) 3 steps, B1/B2 of their first against their plain versions."""
    mesh = make_mesh(data=1, seq=SP_RANKS, device=device)
    check_numerics(f"SP rank {mesh.rank} after make_mesh")
    dev = mesh.device
    batch_g = sp_batch(dev)
    batch = shard_batch(mesh, batch_g, seq_keys=("signal",))
    out = {"mesh": repr(mesh), "transport": collectives.transport(mesh)}
    out["cut"] = objective_grads(sp_model(dev, SP_CUT), batch, mesh)
    model = sp_model(dev)
    out["full"] = objective_grads(model, batch, mesh)
    out["blocks"] = check_blocks(capture_blocks(model, batch, None, JointLoss("joint"),
                                                logit_frames, mesh))
    # the main path: the SP train step, counts zeroed and read each step
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 logit_length_fn=logit_frames, mesh=mesh)
    state = TrainState.create(model.params(), tx)
    expect = {**block_launches(model, 1, 1), "ctc_alpha_segment": 1,
              "ctc_beta_segment": 1}
    with record_ctc() as rec:
        state, hist, launches = train_steps(step, state, batch, expect)
    out.update(launches=launches, losses=[h["total_loss"] for h in hist])
    out["b3"] = check_ctc(rec, "B3")
    del rec, model, step, state
    # (d) DP: 4 reads a rank, full depth, 3 Adagrad steps
    dmesh = make_mesh(data=SP_RANKS, seq=1, device=device)
    model = sp_model(dev)
    batch = shard_batch(dmesh, batch_g)
    # B4/B5 on the DP reads: the first cycle of dilations (1..512) only
    # (every dilation is held on the SP windows above and at the whole batch
    # in phases 1 and 5)
    blocks_dp = check_blocks(capture_blocks(model, batch, None, JointLoss("joint"),
                                            logit_frames, dmesh)[:DP_HELD_BLOCKS])
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 logit_length_fn=logit_frames, mesh=dmesh)
    with record_ctc() as rec:
        state, hist, dp_launches = train_steps(step, TrainState.create(model.params(), tx),
                                               batch, {**block_launches(model, 1, 1),
                                                       "ctc_alpha": 1, "ctc_beta": 1})
    out["dp"] = dict(mesh=repr(dmesh), params=tree_leaves(state.params), launches=dp_launches,
                     losses=[h["total_loss"] for h in hist], blocks=blocks_dp,
                     ctc=check_ctc(rec, "B1/B2"))
    return out


def leaf_rel_errs(got, want):
    """||a - b|| / ||b|| leaf by leaf (0 where both are 0, inf where only b
    is)."""
    out = []
    for a, b in zip(got, want):
        nb, nd = float(b.norm()), float((a.to(b.device) - b).norm())
        out.append(0.0 if nd == 0 else (nd / nb if nb else math.inf))
    return out


def sp_references(dev):
    """The single-device runs phase 8 is held to, on the card: the kernel
    step's objective and gradients at the cut and at full depth, the cuDNN
    composite's (plain CTC) at full depth, and 3 Adagrad steps on the
    kernels and on the cuDNN composite from the full-depth init."""
    batch = sp_batch(dev)
    ref = {"cut": objective_grads(sp_model(dev, SP_CUT), batch)}
    model = sp_model(dev)
    ref["full"] = objective_grads(model, batch)
    with blocks_as(cudnn_block), ctc_plain():
        ref["full_cudnn"] = objective_grads(model, batch)
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 logit_length_fn=logit_frames)
    state0 = TrainState.create(model.params(), tx)
    ref["p0"] = tree_leaves(state0.params)
    ref["dp"] = tree_leaves(train_steps(step, state0, batch)[0].params)
    with blocks_as(cudnn_block), ctc_plain():
        ref["dp_cudnn"] = tree_leaves(train_steps(step, state0, batch)[0].params)
    return ref


def check_chain(ranks, dev):
    """(a), gathered: the ranks' segments laid end to end against B1 and B2
    on the whole sequence (the same cotangent)."""
    c = [r["b3"]["chain"] for r in ranks]
    if [x["t_offset"] for x in c] != [i * c[0]["lp"].shape[0] for i in range(len(c))] or \
            not all(x["alpha_in_live"] for x in c[1:]):
        raise AssertionError("B3: the segments' offsets or carries are not a chain")
    lp = torch.cat([x["lp"] for x in c]).to(dev)
    args = [c[0][k].to(dev) for k in ("skipadd", "lens", "lab")]
    ll, alphas, _ = ctc_fwd(lp, *args)
    grad, _ = ctc_bwd(lp, alphas, *args, ll, c[0]["cot"].to(dev))
    ll_rel = float(((c[-1]["ll"].to(dev) - ll).abs() / ll.abs()).max())
    if ll_rel > 1e-5:
        raise AssertionError(f"B3 chain: ll {ll_rel:.3e} from B1's (relative)")
    g_err = check_close("B3 chain grad", torch.cat([x["grad"] for x in c]).to(dev), grad,
                        CTC_GRAD_RTOL, CTC_GRAD_ATOL)
    return ll_rel, g_err


def run_parallel(dev):
    """Phase 8: SP and DP on 2 gloo ranks on this card, held to single-device
    runs on the card; with 2 or more cards, SP and DP again on NCCL, one
    rank a card."""
    ref = sp_references(dev)
    torch.cuda.empty_cache()
    ranks = run_ranks(sp_rank, SP_RANKS, "gloo", str(dev), timeout=600)
    ranks = [tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t, r) for r in ranks]
    log(f"phase 8: backend: {ranks[0]['transport']}: {SP_RANKS} ranks on 1 card; meshes "
        f"{ranks[0]['mesh']}, {ranks[0]['dp']['mesh']}")
    # (b) the cut depth: loss and every gradient leaf
    loss_rel = max(abs(r["cut"][0] - ref["cut"][0]) / abs(ref["cut"][0]) for r in ranks)
    leaf = max(max(leaf_rel_errs(r["cut"][1], ref["cut"][1])) for r in ranks)
    log(f"(b) SP, depth cut to {len(SP_CUT[0])}+{len(SP_CUT[1])} blocks, L={SP_L}: loss "
        f"{ranks[0]['cut'][0]:.8g} vs single-device kernels {ref['cut'][0]:.8g} (rel {loss_rel:.2e}, "
        f"bound {SP_LOSS_RTOL}); worst gradient leaf ||g_sp - g|| / ||g|| {leaf:.2e} "
        f"(bound {SP_LEAF_RTOL})")
    if not (loss_rel <= SP_LOSS_RTOL and leaf <= SP_LEAF_RTOL):
        raise AssertionError("(b) SP at the cut depth differs from the single-device step")
    # (c) full depth, res_w scaled: the loss, the gradients to the cuDNN yardstick
    loss_rel = max(abs(r["full"][0] - ref["full"][0]) / abs(ref["full"][0]) for r in ranks)
    sp_gap = max(rel_err(r["full"][1], ref["full"][1]) for r in ranks)
    c_gap = rel_err(ref["full_cudnn"][1], ref["full"][1])
    log(f"(c) SP at full depth, res_w scaled: loss rel {loss_rel:.2e} (bound "
        f"{SP_FULL_LOSS_RTOL}); ||g_sp - g|| / ||g|| {sp_gap:.3e}, cuDNN composite's "
        f"{c_gap:.3e}, ratio {sp_gap / c_gap:.3f} (bound {SENS_FACTOR}); launches a step per "
        f"rank {[r['launches'] for r in ranks]}; losses of the 3 SP steps "
        f"{ranks[0]['losses']}")
    if not (loss_rel <= SP_FULL_LOSS_RTOL and sp_gap <= SENS_FACTOR * c_gap):
        raise AssertionError("(c) SP at full depth differs from the single-device step")
    # B4/B5 on the SP halo windows and on the DP ranks' reads
    for i, r in enumerate(ranks):
        log_blocks(f"SP rank {i}", r["blocks"])
        log_blocks(f"DP rank {i}", r["dp"]["blocks"])
    # (a) B3 on each rank, then the chain against B1/B2
    for i, r in enumerate(ranks):
        b = r["b3"]
        log(f"(a) rank {i} (t_offset {b['chain']['t_offset']}): B3-fwd max_abs_err "
            f"{b['fwd']:.3e}; B3-bwd max_abs_err {b['bwd']:.3e}")
    ll_rel, g_err = check_chain(ranks, dev)
    log(f"(a) the chained segments against B1/B2 on the whole sequence: ll rel {ll_rel:.2e} "
        f"(bound 1e-5), grad max_abs_err {g_err:.3e} (rtol {CTC_GRAD_RTOL}, atol "
        f"{CTC_GRAD_ATOL})")
    # (d) DP: identical params on both ranks, updates to the cuDNN yardstick
    pd = [r["dp"]["params"] for r in ranks]
    if not all(torch.equal(a, b) for p in pd[1:] for a, b in zip(p, pd[0])):
        raise AssertionError("(d) DP: the ranks' params differ")
    dp_ = lambda p: [a.to(dev) - b for a, b in zip(p, ref["p0"])]
    upd, upd_c = rel_err(dp_(pd[0]), dp_(ref["dp"])), rel_err(dp_(ref["dp_cudnn"]), dp_(ref["dp"]))
    log(f"(d) DP on {SP_RANKS} ranks (4 reads each), 3 Adagrad steps: params bit-identical "
        f"across ranks; updates ||dp - dp_1|| / ||dp_1|| {upd:.3e}, cuDNN composite's "
        f"{upd_c:.3e}, ratio {upd / upd_c:.3f} (bound {SENS_FACTOR}); launches a step "
        f"{ranks[0]['dp']['launches']}; losses {ranks[0]['dp']['losses']}")
    if not upd <= SENS_FACTOR * upd_c:
        raise AssertionError("(d) DP's updates differ from the single-device steps")
    for i, r in enumerate(ranks):
        c = r["dp"]["ctc"]
        log(f"(d) DP rank {i}: B1 and B2 of its first step (T={SP_L // POOL}, B={B // SP_RANKS}) "
            f"against their plain loops: max_abs_err {c['fwd']:.3e}, {c['bwd']:.3e}")
    if torch.cuda.device_count() >= 2:
        nccl = run_ranks(sp_rank, SP_RANKS, "nccl", None, timeout=600)
        log(f"nccl: {nccl[0]['transport']}, one rank a card: (c) launches "
            f"{[r['launches'] for r in nccl]}")
    else:
        log("nccl: not run (1 device)")


# ---- 9. long-read serving ------------------------------------------------------

LONG_CONFIG = Path(__file__).resolve().parent / "configs" / "gauss_quality.json"
LONG_B, LONG_L = 8, 100_000          # reads above the CLI's 65,536-sample switch
LONG_CHUNK, LONG_CHUNK_BATCH = 16384, 8
# the beam's chunk and label window in (b): a chunk adds at most one label a
# frame, so a window of twice the chunk cannot fill unless a commit leaves
# more than a chunk's worth of labels in it; the CLI in (d) keeps JAX's
# defaults (2048, 4096) and reports its count
LONG_BEAM_FRAMES, LONG_WINDOW = 4096, 8192
CLI_WINDOW = 2048                    # Basecaller.basecall_long_batch's default
PLAIN_BEAM_CHUNKS, PLAIN_BEAM_FRAMES = 3, 1024  # (c): the plain beam is a frame loop
PLAIN_MAIN_CHUNKS = 2                # (c): chunks at the main path's shape, mid-read
LONG_MONO_READS = 2                  # (a), (e): monolithic forwards on 2 reads
# stitched logits against the monolithic forward: the same float32 sums,
# which cuDNN and cuBLAS may take in another order for a (chunk_batch,
# chunk_len) shape than for a whole read; the error scales with the
# logits' magnitude: |chunked - monolithic| <= LONG_LOGIT_RTOL x max|monolithic|
LONG_LOGIT_RTOL = 1e-4
# the head's bias: JAX's long-read test's (tests/test_streaming_beam.py:85-96)
# with blank raised by 2. Its other step, out2.w x 3, is left out: at full
# width it makes the head so confident (max|logit| 48) that beams differing
# at old positions stay in the beam, the live beams' common prefix stops
# growing, and no fixed window holds the uncommitted labels. JAX's bias alone
# aims at the rate that test names, ~1 label in 6 frames, but at full width
# gives ~0.36 labels a frame: more labels stand in a live window before a
# commit than the CLI's window of 2048 holds ((b) logs both; PERF.md §6)
JAX_HEAD_BIAS = (0.6, 0.9, -0.3, 0.1, -0.7)
LONG_HEAD_BIAS = (JAX_HEAD_BIAS[0] + 2.0, *JAX_HEAD_BIAS[1:])


def gauss_model(dev, blocks=None):
    """configs/gauss_quality.json's RawCTCNet at full width from the seed,
    res_w scaled by 1/sqrt(2) (phase 4); blocks: its cycles of dilations
    cut to that many."""
    cfg = json.loads(LONG_CONFIG.read_text())
    if blocks is not None:
        cfg["model"]["raw"]["num_dilation_blocks"] = blocks
    model = Model("raw-ctcnet", cfg, device=dev).init(SEED)
    with torch.no_grad():
        for blk in [model.model_ctc.input_block, *model.model_ctc.stack.blocks]:
            blk.res_w.mul_(0.5 ** 0.5)
    return cfg, model


def long_read_model(dev):
    """gauss_model with the head biased toward blank (LONG_HEAD_BIAS),
    which also parts the eye-init net's near-tied labels."""
    cfg, model = gauss_model(dev)
    with torch.no_grad():
        model.model_ctc.out2.b.add_(torch.tensor(LONG_HEAD_BIAS, device=dev))
    return cfg, model


def window_occupancy(lp, window):
    """The most labels a live beam holds in its window over the streamed
    decode of lp, before and after each commit (B6 launches outside the
    main path), and the decode's labels a frame. A window that stays above
    the first never caps an extension (the saturation count, JAX's, reads
    only the second)."""
    Bx, T, C = lp.shape
    lengths = torch.full((Bx,), T, dtype=torch.int32, device=lp.device)
    state = beam_init(Bx, BEAM_WIDTH, window, device=lp.device)
    live_max = lambda st: int(torch.where(torch.logaddexp(st[2], st[3]) > NEG_INF / 2,
                                          st[1], 0).max())
    before = after = labels = 0
    for s in range(0, T, LONG_BEAM_FRAMES):
        chunk = lp[:, s: s + LONG_BEAM_FRAMES]
        if chunk.shape[1] < LONG_BEAM_FRAMES:
            chunk = torch.cat([chunk, chunk.new_zeros((Bx, LONG_BEAM_FRAMES - chunk.shape[1], C))],
                              dim=1)
        raw = beam_search_kernel(chunk, lengths, beam_width=BEAM_WIDTH, max_label_len=window,
                                 state=state, t0=s)
        state, k = streaming.commit(raw, window)[:2]
        before, after = max(before, live_max(raw)), max(after, live_max(state))
        labels += int(k.sum())
    labels += int(beam_finalize(state)[1][:, 0].sum())
    return before, after, labels / (Bx * T)


def hold_logits(label, got, want):
    """got within LONG_LOGIT_RTOL x max|want| of want; returns (max error,
    max|want|)."""
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    log(f"{label}: {want.shape[0]} reads x {want.shape[1]} frames x {want.shape[2]} compared, "
        f"max_abs_err {err:.3e}, max|monolithic| {scale:.3e} (bound {LONG_LOGIT_RTOL} x max)")
    if not (got.shape == want.shape and err <= LONG_LOGIT_RTOL * scale):
        raise AssertionError(f"{label}: chunked logits differ from the monolithic forward")
    return err, scale


def pool_in_shared(state, frames):
    """Whether B6's node pool for a call of `frames` frames from state fits
    in shared memory (the wrapper's rule: ctc_beam_kernel<true>), or goes to
    the global scratch (ctc_beam_kernel<false>)."""
    n_in = 1 + int(state[1].clamp(0, state[0].shape[2]).sum(1).max())
    lib = _build.library("ctc_beam", ctc_beam_device._SIGNATURES)
    return bool(lib.wst_ctc_beam_pool_in_shared(LABELS, BEAM_WIDTH, LABELS,
                                                 n_in + BEAM_WIDTH * frames))


def stream_chunks(lp, plain, frames, chunks, start=None):
    """(c): `chunks` chunks of `frames` frames through StreamingBeamBatch, on
    B6 or on its plain version, from a copy of `start` (default: the empty
    beam at frame 0); the state, the committed labels and times after each,
    and whether each call's pool fit in shared memory."""
    Bx, T, _ = lp.shape
    sbb = (copy.deepcopy(start) if start is not None else
           StreamingBeamBatch(Bx, [T] * Bx, beam_width=BEAM_WIDTH, label_window=LONG_WINDOW,
                              device=lp.device))
    ctx = (mock.patch.object(streaming, "beam_search_kernel", beam_search_ref) if plain
           else contextlib.nullcontext())
    out, shared = [], []
    with ctx:
        for _ in range(chunks):
            s = sbb.frames_fed
            shared.append(pool_in_shared(sbb.state, frames))
            sbb.feed(lp[:, s: s + frames])
            out.append((tuple(x.cpu() for x in sbb.state), sbb.committed, sbb.committed_times))
    return out, shared


def compare_streams(label, got, want):
    """Each chunk's state equal up to plens (live rows; past plens a row
    holds labels its commits rolled out), the committed labels and times
    equal, scores within BEAM_SCORE_ATOL. Returns (live rows, labels
    committed, max score error)."""
    err, live_rows = 0.0, 0
    for i, ((s1, c1, t1), (s0, c0, t0)) in enumerate(zip(got, want)):
        p1, l1, pb1, pnb1, tm1 = s1
        p0, l0, pb0, pnb0, tm0 = s0
        live = torch.logaddexp(pb0, pnb0) > NEG_INF / 2
        if not torch.equal(live, torch.logaddexp(pb1, pnb1) > NEG_INF / 2):
            raise AssertionError(f"{label} chunk {i}: the live rows differ")
        for b, r in zip(*torch.nonzero(live, as_tuple=True)):
            n = int(l0[b, r])
            if int(l1[b, r]) != n or not (torch.equal(p1[b, r, :n], p0[b, r, :n])
                                          and torch.equal(tm1[b, r, :n], tm0[b, r, :n])):
                raise AssertionError(f"{label} chunk {i}: read {int(b)} row {int(r)} differs")
            err = max(err, float((pb1[b, r] - pb0[b, r]).abs()),
                      float((pnb1[b, r] - pnb0[b, r]).abs()))
            live_rows += 1
        if not all(np.array_equal(a, b) for a, b in zip(c1 + t1, c0 + t0)):
            raise AssertionError(f"{label} chunk {i}: committed labels or times differ")
    if err > BEAM_SCORE_ATOL:
        raise AssertionError(f"{label} scores differ by {err}")
    return live_rows, sum(map(len, want[-1][1])), err


def cli_basecall(cfg, model, reads, tmp, long_flag):
    """(d): the basecall command on a checkpoint of the model's weights;
    returns (sequences, scores, saturated_chunks, launches)."""
    run = Path(tmp) / "long_run"
    cfg = copy.deepcopy(cfg)
    cfg["training"]["save_dir"] = str(run)
    if not (run / "ckpts").is_dir():
        opt = cfg["training"]["optim"]
        tx = build_optimizer(opt["type"], opt["learning_rate"])
        save_checkpoint(str(run / "ckpts"), TrainState.create(model.params(), tx))
        np.save(Path(tmp) / "long_reads.npy", reads)
    cfg_path = Path(tmp) / "long.json"
    cfg_path.write_text(json.dumps(cfg))
    fasta = Path(tmp) / f"long_{long_flag}.fa"
    callers = []
    orig = Basecaller.basecall_long_batch

    def record(self, *a, **kw):
        callers.append(self)
        return orig(self, *a, **kw)

    reset_counts()
    with mock.patch.object(Basecaller, "basecall_long_batch", record):
        rc = cli.main(["basecall", str(cfg_path), "--signals",
                       str(Path(tmp) / "long_reads.npy"), "--out", str(fasta)]
                      + (["--long"] if long_flag else []))
    launches = {k: v for k, v in read_counts().items() if v}
    lines = fasta.read_text().splitlines()
    if rc != 0 or len(callers) != 1 or len(lines) != 2 * len(reads):
        raise AssertionError(f"(d) basecall: rc {rc}, {len(callers)} long calls, "
                             f"{len(lines)} FASTA lines")
    return (lines[1::2], [l.split("score=")[1] for l in lines[::2]],
            callers[0].saturated_chunks, launches)


def phase_long_wavenet(dev):
    """(e): the bench model's causal WaveNet, 2 one-hot reads of LONG_L,
    through chunked_logits(model.model_base, ...) read by read: B4 in every
    chunk forward, the stitched output held to the monolithic base forward,
    B4 at the chunk shape held to its plain version at every block."""
    model = scale_res_w(Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED))
    base = model.model_base
    reads = torch.from_numpy(onehot_reads(np.random.default_rng(SEED + 9), LONG_MONO_READS,
                                          LONG_L, LEVELS)).to(dev)
    margin = _default_margin(base)
    starts, _, _ = _chunk_grid(base, LONG_L, LONG_CHUNK, margin)
    with torch.inference_mode():
        reset_counts()
        chunked = torch.stack(
            [chunked_logits(base, r, LONG_CHUNK, chunk_batch=LONG_CHUNK_BATCH) for r in reads])
        launches = fused_gated_block.launches
        groups = LONG_MONO_READS * math.ceil(len(starts) / LONG_CHUNK_BATCH)
        if launches != len(WAVENET_DILS) * groups or read_counts()["ctc_beam"]:
            raise AssertionError(f"(e) B4 launched {launches} times: expected "
                                 f"{len(WAVENET_DILS)} blocks x {groups} chunk groups")
        hold_logits(f"(e) causal WaveNet ({len(WAVENET_DILS)} blocks, {LEVELS} "
                             f"channels), chunked_logits (margin {margin}, {len(starts)} "
                             f"chunks a read) against the monolithic base forward",
                             chunked, base(reads))
        # B4 at the chunk forwards' shape, on the plain path's activations
        x = base.entry(reads[0, :LONG_CHUNK][None].expand(LONG_CHUNK_BATCH, -1, -1)
                       .contiguous())
        b4_err = 0.0
        for blk in base.stack.blocks:
            a = (blk.gate_w, blk.gate_b, blk.out_w[0], blk.out_b, blk.res_w, blk.res_b)
            want = fused_gated_block_ref(x, *a, blk.dilation)
            b4_err = max(b4_err, hold_b4(blk.dilation, fused_gated_block(x, *a, blk.dilation),
                                         want)[0])
            x = want[0]
    log(f"(e) B4 launches {launches} ({len(WAVENET_DILS)} blocks x {groups} groups of "
        f"{LONG_CHUNK_BATCH} chunks); B4 at the chunk shape ({LONG_CHUNK_BATCH}, {LONG_CHUNK}, "
        f"{LEVELS}) within phase 1's tolerance at all {len(WAVENET_DILS)} blocks, max_abs_err "
        f"{b4_err:.3e}")


def run_long_read(dev):
    """Phase 9: long reads through Basecaller.basecall_long_batch (chunked
    forwards + the streaming beam, B6 with the state carried), the basecall
    command, and a causal WaveNet's chunked forwards (B4)."""
    cfg, model = long_read_model(dev)
    reads = np.random.default_rng(SEED + 8).standard_normal((LONG_B, LONG_L)).astype(np.float32)
    sig = torch.from_numpy(reads[..., None]).to(dev)
    margin = _default_margin(model)
    starts, _, _ = _chunk_grid(model, LONG_L, LONG_CHUNK, margin)
    T = model.output_length(LONG_L)
    log(f"phase 9 model: configs/gauss_quality.json's RawCTCNet, "
        f"{model.model_ctc.num_features} features, {len(model.layers)} stack blocks + the "
        f"input block, non-causal, res_w scaled, head bias {LONG_HEAD_BIAS}; reads {LONG_B} x "
        f"{LONG_L} raw samples -> {T} logit frames; margin {margin}, {len(starts)} chunks of "
        f"{LONG_CHUNK} a read in groups of {LONG_CHUNK_BATCH}")
    caller = Basecaller(model, beam_width=BEAM_WIDTH, logit_length_fn=model.output_length,
                        device=dev)
    long_kw = dict(chunk_len=LONG_CHUNK, chunk_batch=LONG_CHUNK_BATCH,
                   beam_chunk_frames=LONG_BEAM_FRAMES, label_window=LONG_WINDOW)
    with torch.inference_mode():
        # ---- (a) the chunked forwards against the monolithic forward
        logits = chunked_logits_batch(model, sig, LONG_CHUNK, chunk_batch=LONG_CHUNK_BATCH)
        if logits.shape != (LONG_B, T, LABELS) or not torch.isfinite(logits).all():
            raise AssertionError(f"(a) logits {tuple(logits.shape)} not finite/shaped")
        hold_logits(f"(a) chunked_logits_batch ({LONG_B * len(starts)} chunk "
                               f"forwards) against the monolithic forward",
                               logits[:LONG_MONO_READS], model(sig[:LONG_MONO_READS]))
        lp = torch.log_softmax(logits, -1)
        # ---- (b) the main path: the long call, B6 on the carried state
        reset_counts()
        seqs, scores = caller.basecall_long_batch(reads[..., None], **long_kw)
        launches = {k: v for k, v in read_counts().items() if v}
        want_launches = {"ctc_beam": math.ceil(T / LONG_BEAM_FRAMES), **block_launches(
            model, math.ceil(LONG_B * len(starts) / LONG_CHUNK_BATCH))}
        if launches != want_launches or caller.saturated_chunks:
            raise AssertionError(f"(b) launches {launches} (expected {want_launches}), "
                                 f"saturated chunks {caller.saturated_chunks}")
        lengths = torch.full((LONG_B,), T, dtype=torch.int32, device=dev)
        mono = beam_finalize(beam_search_kernel(lp, lengths, beam_width=BEAM_WIDTH,
                                                max_label_len=T))
        mono_seqs = labels2strings([mono[0][b, 0, : int(mono[1][b, 0])].cpu().numpy()
                                    for b in range(LONG_B)])
        score_err = max(abs(a - float(b)) for a, b in zip(scores, mono[2][:, 0]))
        if seqs != mono_seqs or score_err > BEAM_SCORE_ATOL:
            raise AssertionError(f"(b) streamed decode differs from one B6 call: reads "
                                 f"{[b for b in range(LONG_B) if seqs[b] != mono_seqs[b]]}, "
                                 f"score diff {score_err:.3e}")
        rate = sum(map(len, seqs)) / (LONG_B * T)
        occupancy = {w: window_occupancy(lp, w)[:2] for w in (LONG_WINDOW, CLI_WINDOW)}
        log(f"(b) basecall_long_batch: launches {launches} ({T} frames in chunks of "
            f"{LONG_BEAM_FRAMES}, window {LONG_WINDOW}), saturated chunks 0; the streamed "
            f"labels of all {LONG_B} reads equal one B6 call over the stitched log-probs "
            f"(S = T = {T}), max score diff {score_err:.3e}; {rate:.3f} labels a frame, "
            f"mean length {sum(map(len, seqs)) / LONG_B:.0f}; most labels in a live window "
            f"before / after a commit: " + ", ".join(
                f"window {w}: {b} / {a}" for w, (b, a) in occupancy.items()))
        if any(b >= w for w, (b, _) in occupancy.items()):
            raise AssertionError(f"(b) a label window filled: {occupancy}")
        # the same logits with JAX's test bias alone (blank 2 lower), for the record
        jax_lp = torch.log_softmax(logits + logits.new_tensor(JAX_HEAD_BIAS)
                                   - logits.new_tensor(LONG_HEAD_BIAS), -1)
        j_before, j_after, j_rate = window_occupancy(jax_lp, LONG_WINDOW)
        log(f"(b) the head with JAX's test bias {JAX_HEAD_BIAS} alone: {j_rate:.3f} labels a "
            f"frame; most labels in a live window before / after a commit {j_before} / "
            f"{j_after} (window {LONG_WINDOW}; the CLI's {CLI_WINDOW} "
            f"{'would fill' if j_before >= CLI_WINDOW else 'holds'})")
        del jax_lp
        # ---- (c) streaming on B6 against streaming on its plain version: the
        # first chunks of 1024 frames (the pool in shared memory), then chunks
        # at the main path's shape from its carried state mid-read (the pool
        # in the global scratch, as in every call of (b))
        mid = math.ceil(T / LONG_BEAM_FRAMES) // 2
        start = StreamingBeamBatch(LONG_B, [T] * LONG_B, beam_width=BEAM_WIDTH,
                                   label_window=LONG_WINDOW, device=dev)
        for i in range(mid):
            start.feed(lp[:, i * LONG_BEAM_FRAMES: (i + 1) * LONG_BEAM_FRAMES])
        for c_label, frames, chunks, first, in_shared in (
                ("(c)", PLAIN_BEAM_FRAMES, PLAIN_BEAM_CHUNKS, None, True),
                ("(c, main shape)", LONG_BEAM_FRAMES, PLAIN_MAIN_CHUNKS, start, False)):
            reset_counts()
            on_kernel, shared = stream_chunks(lp, False, frames, chunks, first)
            if read_counts()["ctc_beam"] != chunks:
                raise AssertionError(f"{c_label} B6 not launched once a chunk")
            if shared != [in_shared] * chunks:
                raise AssertionError(f"{c_label} pool in shared memory {shared}, expected "
                                     f"{in_shared}")
            on_plain, _ = stream_chunks(lp, True, frames, chunks, first)
            if read_counts()["ctc_beam"] != chunks:
                raise AssertionError(f"{c_label} the plain stream launched B6")
            live_rows, committed, c_err = compare_streams(c_label, on_kernel, on_plain)
            t_first = 0 if first is None else first.frames_fed
            log(f"{c_label} {chunks} chunks of ({LONG_B}, {frames}, {LABELS}) from frame "
                f"{t_first} (B6's pool in {'shared memory' if in_shared else 'the global scratch'}"
                f"), streamed on B6 and on its plain version: every chunk's "
                f"{live_rows // chunks} live rows equal up to plens, {committed} committed "
                f"labels and their times equal, max score error {c_err:.3e}")
    # ---- (d) the basecall command on a checkpoint of these weights, against
    # the API driven through the CLI's margin-0 wrapper (the JAX CLI's path)
    t = cfg["training"]
    pipe = Basecaller(cli.ForwardOnly(model), beam_width=t.get("beam_width", 7),
                      cutoff_top_n=t.get("cutoff_top_n"), logit_length_fn=model.output_length,
                      device=dev)
    with torch.inference_mode():
        pseqs, pscores = pipe.basecall_long_batch(reads[..., None])
    with tempfile.TemporaryDirectory() as tmp:
        fasta = {}
        for long_flag in (True, False):
            fasta[long_flag] = cli_basecall(cfg, model, reads, tmp, long_flag)
    for long_flag, (cseqs, cscores, sat, cl) in fasta.items():
        name = "--long" if long_flag else "the automatic switch"
        if sat:
            raise AssertionError(f"(d) basecall, {name}: the label window saturated in {sat} "
                                 f"(chunk, read) pairs")
        if cseqs != pseqs or cscores != [f"{s:.3f}" for s in pscores]:
            raise AssertionError(f"(d) basecall, {name}: the FASTA differs from the API's "
                                 f"through cli.ForwardOnly")
    log(f"(d) basecall command (JAX's defaults: window 2048, beam chunks 4096), --long and "
        f"the automatic switch above 65,536 samples: FASTA equal to basecall_long_batch "
        f"through the CLI's margin-0 wrapper (cli.ForwardOnly, as the JAX CLI); saturated "
        f"(chunk, read) pairs 0; launches {fasta[True][3]}; its basecalls differ from (b)'s "
        f"(the model's margin {margin}) in {sum(a != b for a, b in zip(pseqs, seqs))} of "
        f"{LONG_B} reads")
    del model, caller, logits, lp, sig, start
    torch.cuda.empty_cache()
    # ---- (e) a causal WaveNet's chunked forwards: B4 in every chunk
    phase_long_wavenet(dev)


# ---- 10. RawCTCNet training and evaluation -------------------------------------

# configs/gauss_quality.json as it stands (512 features, 25 + 1 non-causal
# blocks, raw-gauss B=6 at 6 samples a base, Adamax 2e-4, CTC loss), cut to
# 20 steps a run and 5 held-out batches an evaluate
GAUSS_STEPS, GAUSS_PRINT, GAUSS_EVAL_BATCHES = 20, 10, 5
GAUSS_LR = 2e-4
# the running statistics in the checkpoint against the EMA recomputed in
# float64 from the batches the loop was fed: float32 means over B x L
# samples and 40 float32 EMA steps
BN_RTOL = 1e-5
# the printed loss (4 decimals) against the eval step recomputed
EVAL_LOSS_ATOL = 5e-5


def gauss_cfg(run_dir):
    cfg = json.loads(LONG_CONFIG.read_text())
    cfg["training"].update(save_dir=str(run_dir), max_iters=GAUSS_STEPS,
                           print_every=GAUSS_PRINT, save_every=GAUSS_PRINT,
                           eval_batches=GAUSS_EVAL_BATCHES, beam_width=BEAM_WIDTH)
    return cfg


def gauss_train_runs(cfg, run_dir, dev):
    """(a) cli.train_with_result twice on one run directory: 20 steps, then
    resumed at 20 to 40. Each train step launches B1 and B2 once, each
    validation forward B1 once, and B4 and B5 once a centred block a forward
    and a backward."""
    for run, (start, end) in enumerate(((0, GAUSS_STEPS), (GAUSS_STEPS, 2 * GAUSS_STEPS)), 1):
        logged = len(read_jsonl(run_dir / "logs" / "metrics.jsonl")) if run > 1 else 0
        reset_counts()
        result = cli.train_with_result(copy.deepcopy(cfg), dev)
        torch.cuda.synchronize()
        run_counts = {k: v for k, v in read_counts().items() if v}
        lines = read_jsonl(run_dir / "logs" / "metrics.jsonl")[logged:]
        steps, valid = end - start, len(lines)
        messages = (run_dir / "logs" / "messages.log").read_text()
        ckpts = sorted(int(p.name) for p in (run_dir / "ckpts").iterdir() if p.name.isdigit())
        want = {"ctc_alpha": steps + valid, "ctc_beta": steps,
                **cfg_block_launches(cfg, steps + valid, steps)}
        losses = [v for l in lines for v in (l["train_loss"], l["valid_loss"])]
        problems = [what for what, bad in (
            (f"steps {result['steps']} != {end}", result["steps"] != end),
            (f"launches {run_counts} != {want}", run_counts != want),
            (f"non-finite losses {losses}", not all(map(math.isfinite, losses))),
            (f"{valid} log lines", valid != steps // GAUSS_PRINT),
            (f"checkpoints {ckpts}", ckpts != list(range(GAUSS_PRINT, end + 1, GAUSS_PRINT))),
            ("no training.log", not (run_dir / "logs" / "training.log").is_file()),
            (f"did not resume at step {GAUSS_STEPS}", run > 1 and
             f"resumed from {run_dir}/ckpts/ @ step {GAUSS_STEPS}" not in messages))
            if bad]
        if problems:
            raise AssertionError(f"(a) train, run {run}: " + "; ".join(problems))
        log(f"(a) train run {run}: steps {start + 1}-{end}; losses "
            + ", ".join(f"step {l['step']} train {l['train_loss']:.4f} valid "
                        f"{l['valid_loss']:.4f}" for l in lines)
            + f"; launches {run_counts}; checkpoints {ckpts}")


def check_running_stats(cfg, state):
    """(b) The checkpoint's BatchNorm mean and var against the EMA
    (momentum 0.1, unbiased batch variance) recomputed in float64 from the
    training stream rebuilt from the seed: each run restarts it, as the JAX
    CLI's does, so the 40 steps took its first 20 batches twice."""
    mean, var = np.zeros(1), np.ones(1)
    for _ in range(2):
        ds = cli.build_dataset(cfg)
        for _ in range(GAUSS_STEPS):
            x = ds.fetch("train").signal.astype(np.float64)
            n = x.shape[0] * x.shape[1]
            mean = 0.9 * mean + 0.1 * x.mean(axis=(0, 1))
            var = 0.9 * var + 0.1 * x.var(axis=(0, 1)) * n / (n - 1)
    base = state.params["base"]
    got = np.array([float(base["mean"]), float(base["var"])])
    want = np.array([mean[0], var[0]])
    rel = np.abs(got - want) / np.abs(want)
    log(f"(b) running statistics after {2 * GAUSS_STEPS} steps: mean {got[0]:.6f}, var "
        f"{got[1]:.6f}; the float64 EMA over the rebuilt stream {want[0]:.6f}, {want[1]:.6f} "
        f"(relative error {rel.max():.2e}, bound {BN_RTOL})")
    if not (rel <= BN_RTOL).all():
        raise AssertionError("(b) BatchNorm's running statistics differ from the EMA")


def gauss_step_inputs(model, state, batch):
    """(c) What the real step feeds B1 and B2: the train-form forward's
    logits, extended log-probs and skip mask."""
    p = state.params
    with torch.no_grad():
        base = torch.func.functional_call(model.model_base, p["base"], (batch["signal"],))
        logits = torch.func.functional_call(model.model_ctc, p["ctc"], (base,))
    ext, allow = _extend_labels(batch["labels"], 0)
    lp_ext = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
    return logits, lp_ext, torch.where(allow, 0.0, NEG)


def ctc_step_run(net, params, batch, plain):
    """3 steps of make_ctc_train_step (preprocess=batch_standardize, Adamax)
    from params; plain routes the CTC through B1's and B2's plain loops.
    Returns (state, metrics, the first step's launches, the first step's
    gradient leaves as they reach the optimizer)."""
    tx = build_optimizer("adamax", GAUSS_LR)
    step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
    state = TrainState.create(params, tx)
    grads, guarded = [], trainer._guarded_update

    def record(st, total, g, *rest):
        if not grads:
            grads.append([t.clone() for t in tree_leaves(g)])
        return guarded(st, total, g, *rest)

    with (ctc_plain() if plain else contextlib.nullcontext()), \
            mock.patch.object(trainer, "_guarded_update", record):
        state, hist, launches = train_steps(step, state, batch, None if plain else {
            "ctc_alpha": 1, "ctc_beta": 1, **block_launches(net, 1, 1)})
    if plain and {k for k in launches if k.startswith("ctc")}:
        raise AssertionError(f"(d) the plain CTC steps launched {launches}")
    return state, hist, launches, grads[0]


def phase_ctc_step(dev, batch):
    """(d) make_ctc_train_step at full width, res_w scaled as in phase 4: 3
    steps on B1/B2, and twice 3 steps on their plain loops. Under the
    port's numerics (deterministic cuDNN) the two plain runs must agree to
    the bit: params, Adamax's first moment mu, the first step's gradients
    and the losses (C2). The steps differ only in the CTC, whose kernels
    match the plain loops, so the kernel steps' first gradient tree (before
    the optimizer: a B2 that scales every gradient by one constant shows
    there, and in mu, where Adamax's sign-like updates hide it), their
    params, their updates and their mu lie within STEP_PARAM_RTOL of the
    plain steps'. Then a small model's 3 steps on the card against the
    CPU's."""
    _, model = gauss_model(dev)
    net = model.model_ctc
    p0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    kstate, khist, launches, gk = ctc_step_run(net, p0, batch, False)
    pstate, phist, _, gp = ctc_step_run(net, p0, batch, True)
    qstate, qhist, _, gq = ctc_step_run(net, p0, batch, True)
    l0, lk, lp_, lq = (tree_leaves(x) for x in (p0, kstate.params, pstate.params,
                                                 qstate.params))
    mu = lambda st: tree_leaves(st.opt_state[0][0]["mu"])  # build_optimizer("adamax")
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    if not (same(lp_, lq) and same(mu(pstate), mu(qstate)) and same(gp, gq)
            and phist == qhist):
        raise AssertionError(
            f"(d) two plain-CTC runs from one params and batch differ (C2): params "
            f"{rel_err(lq, lp_):.3e}, mu {rel_err(mu(qstate), mu(pstate)):.3e}, step 1's "
            f"gradients {rel_err(gq, gp):.3e}, losses {phist} vs {qhist}")
    dp = lambda ps: [a - b for a, b in zip(ps, l0)]
    errs = {"step 1's gradients": (rel_err(gk, gp), same(gk, gp)),
            "params": (rel_err(lk, lp_), same(lk, lp_)),
            "updates": (rel_err(dp(lk), dp(lp_)), same(lk, lp_)),
            "Adamax's mu": (rel_err(mu(kstate), mu(pstate)), same(mu(kstate), mu(pstate)))}
    loss_err = max(abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                   for a, b in zip(khist, phist))
    log(f"(d) make_ctc_train_step (preprocess=batch_standardize, Adamax {GAUSS_LR}, res_w "
        f"scaled), 3 steps: launches a step {launches}; losses "
        f"{[round(h['total_loss'], 5) for h in khist]}; two plain-CTC runs equal to the bit "
        f"(params, mu, step 1's gradients, losses); the kernel CTC's against the plain "
        f"CTC's (bound {STEP_PARAM_RTOL}): "
        + ", ".join(f"{k} {e:.3e}{' (bit-equal)' if bit else ''}"
                    for k, (e, bit) in errs.items())
        + f", max relative loss difference {loss_err:.3e}")
    if not all(e <= STEP_PARAM_RTOL for e, _ in errs.values()):
        raise AssertionError("(d) the kernel CTC steps differ from the plain CTC steps")
    del model, net, kstate, pstate, qstate
    small_ctc_steps(dev)


REPRO_STEPS = 10


def reproducible_train_runs(dev):
    """(f) C2 end to end: cli.train_with_result on configs/gauss_quality.json
    from its seed, REPRO_STEPS steps, twice, each in a fresh run directory;
    the two final checkpoints must be equal to the bit."""
    payloads = []
    for _ in range(2):
        run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_repro_"))
        try:
            cfg = gauss_cfg(run_dir)
            cfg["training"].update(max_iters=REPRO_STEPS, print_every=REPRO_STEPS,
                                   save_every=REPRO_STEPS)
            cli.train_with_result(cfg, dev)
            payloads.append(torch.load(run_dir / "ckpts" / str(REPRO_STEPS) / "state.pt",
                                       map_location="cpu", weights_only=True))
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
    a, b = (tree_leaves(p) for p in payloads)
    differ = [i for i, (x, y) in enumerate(zip(a, b))
              if not (torch.equal(x, y) if torch.is_tensor(x) else x == y)]
    pa, pb = (tree_leaves(p["params"]) for p in payloads)
    if differ or len(a) != len(b):
        raise AssertionError(f"(f) two train runs from one seed differ (C2): {len(differ)} of "
                             f"{len(a)} checkpoint leaves, params {rel_err(pb, pa):.3e} apart")
    log(f"(f) two {REPRO_STEPS}-step train runs of configs/gauss_quality.json from its seed, "
        f"each in a fresh run directory: final checkpoints equal to the bit ({len(a)} leaves: "
        f"params, Adamax's state, step)")


def small_ctc_steps(dev):
    """A small RawCTCNet (16 features, dilations 1, 2, 4): 3 steps of
    make_ctc_train_step with batch_standardize on the card and on the CPU
    from the same weights; the metrics within 1e-4 relative, each element of
    the params and the optimizer state within 1e-4 relative plus 1e-4 of its
    leaf's largest magnitude (as tests/test_torch_ctc_step.py)."""
    layers = tuple((16, 16, 3, d) for d in (1, 2, 4))
    ds = Dataset("raw-gauss", batch_size=3, min_length=30, max_length=40, upsampling=3,
                 seed=SEED + 10)
    batch = {k: v for k, v in dataclasses.asdict(ds.fetch("train")).items()}
    out = []
    for device in (dev, "cpu"):
        net = RawCTCNet(16, 3, LABELS, layers, 16, softmax=False, device="cpu")
        net.reset_parameters(torch.Generator().manual_seed(SEED + 3))
        net = net.to(device)
        tx = build_optimizer("adamax", 1e-3)
        step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
        state = TrainState.create({k: v.detach().clone() for k, v in net.state_dict().items()},
                                  tx)
        hist = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items()})
        out.append((hist, [t.cpu() for t in tree_leaves((state.params, state.opt_state))]))
    (hk, pk), (hc, pc) = out
    for a, b in zip(hk, hc):
        for k in b:
            if not math.isclose(a[k], b[k], rel_tol=1e-4, abs_tol=1e-6):
                raise AssertionError(f"small RawCTCNet: card {k}={a[k]} != CPU {b[k]}")
    for a, b in zip(pk, pc):
        scale = float(b.abs().max()) if b.numel() else 0.0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale)
    log(f"(d) small RawCTCNet (16 features, 3 blocks, batch_standardize): 3 steps on the "
        f"card equal the CPU's (losses {[round(h['total_loss'], 5) for h in hk]})")


def run_evaluate(cfg_path, decoder):
    """(e) The evaluate command; returns (batches, loss, identity, launches,
    the printed line)."""
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["evaluate", str(cfg_path)])
    launches = {k: v for k, v in read_counts().items() if v}
    line = buf.getvalue().strip().splitlines()[-1]
    m = re.match(r"eval loss over (\d+) batches: (\S+) \| basecall identity: (\S+)$", line)
    if rc != 0 or not m:
        raise AssertionError(f"(e) evaluate ({decoder}): rc {rc}, output {buf.getvalue()!r}")
    return int(m[1]), float(m[2]), m[3], launches, line


def phase_evaluate(cfg, run_dir, model, state, eval_fn):
    """(e) evaluate on (a)'s run directory, decoder beam (W=7) and argmax:
    B1 once a batch (the eval step), B6 once a batch for beam; the printed
    loss equals the eval step on the same held-out batches, and the identity
    batch_identity of the same logits decoded by beam_search_ref, B6's
    plain version, which B6 must equal row for row (for argmax, by an
    argmax and CTC collapse written out here, not the port's decoder)."""
    ref_ids, ref_ids_argmax, losses = [], [], []
    ds = cli.build_dataset(cfg)
    err = 0.0
    for i in range(GAUSS_EVAL_BATCHES):
        b = ds.fetch("valid")
        batch = batch_to_device(b, model.device)
        losses.append(float(eval_fn(state.params, batch)["total_loss"]))
        with torch.no_grad():
            logits = model(batch["signal"])
        frames = model.output_length(b.signal_lengths)
        lengths = torch.as_tensor(frames, dtype=torch.int32, device=model.device)
        lp = torch.log_softmax(logits.float(), -1)
        T = lp.shape[1]
        kw = dict(beam_width=BEAM_WIDTH, max_label_len=T)
        want = beam_finalize(beam_search_ref(lp, lengths, **kw))
        _, e = compare_beams(beam_finalize(beam_search_kernel(lp, lengths, **kw)), want,
                             BEAM_WIDTH)
        err = max(err, e)
        targets = labels2strings([b.labels[r, :b.label_lengths[r]] for r in range(len(b.labels))])
        decoded = labels2strings([want[0][r, 0, :int(want[1][r, 0])].cpu().numpy()
                                  for r in range(len(b.labels))])
        ref_ids.append(batch_identity([list(d) for d in decoded], targets)[0])
        best = logits.argmax(-1).cpu().numpy()
        greedy = []
        for r in range(len(b.labels)):  # collapse repeats, then drop blanks (label 0)
            row = best[r, :int(frames[r])]
            greedy.append([int(c) for i, c in enumerate(row) if c and (i == 0 or c != row[i - 1])])
        ref_ids_argmax.append(batch_identity([list(d) for d in labels2strings(greedy)],
                                             targets)[0])
        if i == 0:
            shape = f"B={lp.shape[0]} T={T} C={lp.shape[2]} W={BEAM_WIDTH} S={T}"
    want_loss = float(np.mean(losses))
    for decoder, ids in (("beam", ref_ids), ("argmax", ref_ids_argmax)):
        c = copy.deepcopy(cfg)
        c["training"]["decoder"] = decoder
        path = run_dir / f"evaluate_{decoder}.json"
        path.write_text(json.dumps(c))
        n, loss, ident, launches, line = run_evaluate(path, decoder)
        # B4: the eval step's forward and the decoder's, a batch
        want_launches = {"ctc_alpha": GAUSS_EVAL_BATCHES,
                         **block_launches(model, 2 * GAUSS_EVAL_BATCHES)}
        if decoder == "beam":
            want_launches["ctc_beam"] = GAUSS_EVAL_BATCHES
        want_ident = f"{np.mean(ids):.3f}"
        problems = [what for what, bad in (
            (f"{n} batches", n != GAUSS_EVAL_BATCHES),
            (f"launches {launches} != {want_launches}", launches != want_launches),
            (f"loss {loss} != the eval step's {want_loss:.6f}",
             abs(loss - want_loss) > EVAL_LOSS_ATOL + 1e-6 * abs(want_loss)),
            (f"identity {ident} != the plain decode's {want_ident}", ident != want_ident))
            if bad]
        if problems:
            raise AssertionError(f"(e) evaluate ({decoder}): " + "; ".join(problems))
        log(f"(e) evaluate, decoder {decoder}: {line!r}; launches {launches}; the eval step "
            f"recomputed {want_loss:.6f}, the identity of the plain decode {want_ident}")
    log(f"(e) B6 at {shape}: every live row of the {GAUSS_EVAL_BATCHES} batches equal "
        f"to beam_search_ref's (max score error {err:.3e})")


def run_gauss_training(dev):
    """Phase 10: configs/gauss_quality.json trained through the train
    command and scored through evaluate, make_ctc_train_step at its width,
    B1/B2 and B6 at its shapes."""
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_gauss_"))
    try:
        cfg = gauss_cfg(run_dir)
        raw, tr = cfg["model"]["raw"], cfg["training"]
        log(f"phase 10 model: configs/gauss_quality.json's RawCTCNet ({raw['num_features']} "
            f"features, {raw['num_dilation_blocks']} x {raw['dilations']} blocks + the input "
            f"block, causal {raw['causal']}), {tr['datatype']} B={tr['batch_size']}, "
            f"{GAUSS_STEPS} steps a run")
        # ---- (a) the main path: the train command, then resumed
        gauss_train_runs(cfg, run_dir, dev)
        ds, model, state, _, eval_fn, _ = cli.build_from_config(
            copy.deepcopy(cfg), dev)
        state = restore_checkpoint(str(run_dir / "ckpts"), state)
        model.load_params(state.params)
        # ---- (b) BatchNorm's running statistics
        check_running_stats(cfg, state)
        # ---- (c) B1 and B2 on the real step's inputs at this shape
        b = ds.fetch("train")
        batch = batch_to_device(b, dev)
        logits, lp_ext, skip = gauss_step_inputs(model, state, batch)
        T, Bx, J = lp_ext.shape
        log(f"(c) B=6 T={T} J={J}: geometry (R, C, threads, D) "
            f"{ctc_scan.ctc_geometry(J, 1, Bx, ctc_scan._sms(lp_ext.device))} (B1), "
            f"{ctc_scan.ctc_geometry(J, 2, Bx, ctc_scan._sms(lp_ext.device))} (B2)")
        phase_ctc(lp_ext, skip, logits, batch)
        # ---- (e) the evaluate command
        phase_evaluate(cfg, run_dir, model, state, eval_fn)
        del model, state, ds, logits, lp_ext
        torch.cuda.empty_cache()
        # ---- (d) make_ctc_train_step at full width
        phase_ctc_step(dev, batch)
        # ---- (f) two train runs from one seed
        reproducible_train_runs(dev)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# ---- 11. the HDF5 read path: configs/ecoli_hdf5_quality.json -------------------

ECOLI_CONFIG = Path(__file__).resolve().parent / "configs" / "ecoli_hdf5_quality.json"
REALREAD = Path(__file__).resolve().parent / "tests" / "golden" / "realread_window.npz"
# tests/make_golden_realread.py: the read and the worker's windows
READ_SEED, WORKER_SEED, REALREAD_EVENTS = 123, 5, 400
REALREAD_SAMPLE_LENGTHS, REALREAD_BATCH = (16, 20), 2
# tests/test_realread_overfit.py: 32 channels, Adam 2e-3, per-char CTC criteria
OVERFIT_C, OVERFIT_LR, OVERFIT_MAX_STEPS = 32, 2e-3, 2500
OVERFIT_CROSS, OVERFIT_STOP = 0.3, 0.02
# the read set: 8 reads x 4000 events at 256 levels, 4-11 samples an event, so
# every window of 90-110 events fits pad_to 1216 and its labels 120
ECOLI_READS, ECOLI_EVENTS = 8, 4000
ECOLI_STEPS, ECOLI_PRINT, ECOLI_EVAL_BATCHES = 20, 10, 4


def make_read(rng, n_events, means, stdvs, num_levels, dwell=(4, 12)):
    """tools/make_synthetic_reads.make_read on the port's MuLawQuantizer and
    kmer_ids: one read's reference bases, event positions and per-event
    quantized sample chunks."""
    bases = rng.integers(1, 5, size=n_events + 8).astype(np.int32)
    ks = kmer_ids(bases, trim=0)[:n_events]
    dwells = rng.integers(dwell[0], dwell[1], size=n_events)
    picoamps = rng.normal(np.repeat(means[ks], dwells), np.repeat(stdvs[ks], dwells))
    quant = MuLawQuantizer(num_levels)(picoamps).astype(np.int64)
    return bases, np.arange(n_events, dtype=np.int64), np.split(quant, np.cumsum(dwells)[:-1])


def make_reads(seed, n_reads, n_events):
    """n_reads reads from one generator, as tools/make_synthetic_reads.py
    writes them."""
    npz = np.load(DEFAULT_KMER_MODEL)
    rng = np.random.default_rng(seed)
    return [make_read(rng, n_events, npz["means"], npz["stdvs"], LEVELS)
            for _ in range(n_reads)]


class H5Groups:
    """What the port's HDF5 readers use of an h5py.File opened for reading
    (keys(), [] and close()), over nested dicts of arrays in memory."""

    def __init__(self, groups):
        self.groups = groups

    def keys(self):
        return self.groups.keys()

    def __getitem__(self, key):
        return self.groups[key]

    def close(self):
        pass


def read_groups(reads):
    """Reads in the /read_i/{quantized, raw/positions, reference} layout of
    tools/make_synthetic_reads.py."""
    groups = {}
    for i, (bases, positions, chunks) in enumerate(reads):
        quantized = np.empty(len(chunks), dtype=object)
        for j, c in enumerate(chunks):
            quantized[j] = c
        groups[f"read_{i}"] = {"quantized": quantized, "raw": {"positions": positions},
                               "reference": bases}
    return groups


def h5py_or_none():
    try:
        return importlib.import_module("h5py")
    except ImportError:
        return None


@contextlib.contextmanager
def stand_in_h5py(path, groups):
    """A stand-in h5py module whose File(path) serves groups from memory
    sits in sys.modules until the block ends (a machine without h5py)."""
    served, stand_in = H5Groups(groups), types.ModuleType("h5py")

    def open_file(name, mode="r"):
        if str(name) != str(path) or mode != "r":
            raise OSError(f"the stand-in h5py opens only {path}, for reading")
        return served

    stand_in.File = open_file
    sys.modules["h5py"] = stand_in
    try:
        yield "no h5py here: a stand-in h5py module serving the data from memory"
    finally:
        del sys.modules["h5py"]


@contextlib.contextmanager
def reads_file(path, reads):
    """A file at path holding reads in the layout of
    tools/make_synthetic_reads.py, for the port's own ``h5py.File`` calls:
    written with h5py where it imports, else served by ``stand_in_h5py``.
    Yields which of the two ran."""
    h5py = h5py_or_none()
    if h5py is None:
        with stand_in_h5py(path, read_groups(reads)) as how:
            yield how
        return
    with h5py.File(path, "w") as f:
        for i, (bases, positions, chunks) in enumerate(reads):
            g = f.create_group(f"read_{i}")
            g.create_dataset("quantized", (len(chunks),),
                             dtype=h5py.vlen_dtype(np.dtype("int64")))[:] = chunks
            g.create_group("raw").create_dataset("positions", data=positions)
            g.create_dataset("reference", data=bases)
    yield f"h5py {h5py.__version__}: a file written"


def rebuild_fixture(tmp):
    """(a) tests/golden/realread_window.npz rebuilt bit for bit by the port's
    ecoli_worker_fn, through h5py.File, on the read of this script's copy of
    make_read, as tests/make_golden_realread.py builds it."""
    want = dict(np.load(REALREAD, allow_pickle=False))
    path = Path(tmp) / "one_read.hdf5"
    with reads_file(path, make_reads(READ_SEED, 1, REALREAD_EVENTS)) as how:
        f = sys.modules["h5py"].File(str(path), "r")
        try:
            read, subintervals, batch = ecoli_worker_fn(
                f, ["read_0"], np.random.default_rng(WORKER_SEED), batch_size=REALREAD_BATCH,
                sample_lengths=REALREAD_SAMPLE_LENGTHS, num_levels=LEVELS, debug_mode=True,
                device_onehot=True)
        finally:
            f.close()
    got = dict(dataclasses.asdict(batch), subintervals=np.asarray(subintervals, np.int64))
    bad = [k for k in want if not (got[k].dtype == want[k].dtype
                                   and np.array_equal(got[k], want[k]))]
    if bad:
        raise AssertionError(f"(a) the port's worker does not rebuild the fixture: {bad}")
    log(f"(a) tests/golden/realread_window.npz rebuilt bit for bit by the port's "
        f"ecoli_worker_fn ({how}): {read}, subintervals {subintervals}, signal "
        f"{got['signal'].shape} {got['signal'].dtype} levels, labels {got['labels'].shape}")
    return want


def overfit_realread(dev, fx):
    """(b) tests/test_realread_overfit.py on the card, float32: the joint
    WaveNet-CTC (256 levels, WaveNet (32, 32, 2, d) for d = 1, 2, 4, a
    classifier of 6 such blocks, pool 1), Adam 2e-3, on the fixture's levels
    batch, one-hot in the step; at most 2500 steps, stopping below per-char
    CTC 0.02. It must cross 0.3 and greedy-decode the read's bases exactly.
    B4 and B5 (float32) launch 3 times a step, B1 and B2 once; both block
    kernels are held at C = 32 on the first step's inputs first (the causal
    blocks; B4 and B5 launch at the classifier's 7 centred blocks too)."""
    layers = [[OVERFIT_C, OVERFIT_C, 2, d] for d in (1, 2, 4)]
    cfg = {"model": {"base": {"signal_dim": LEVELS, "entry_kwidth": 2, "layers": layers},
                     "classifier": {"num_labels": LABELS, "layers": layers * 2,
                                    "out_dim": OVERFIT_C, "downsample": 1}}}
    model = Model("wavenet-ctc", cfg, device=dev).init(SEED)
    batch = {k: torch.from_numpy(fx[k].astype(np.int32)).to(dev) for k in FIELDS}
    f_err, b_err = hold_blocks(capture_blocks(model, batch, None))
    tx = build_optimizer("adam", OVERFIT_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"))
    state = TrainState.create(model.params(), tx)
    frames, n_labels = batch["signal"].shape[1], float(batch["label_lengths"].sum())
    crossed = per_char = None
    reset_counts()
    for i in range(OVERFIT_MAX_STEPS):
        state, m = step(state, batch)
        per_char = float(m["ctc_loss"]) * frames / n_labels
        if crossed is None and per_char < OVERFIT_CROSS:
            crossed = i + 1
        if per_char < OVERFIT_STOP:
            break
    steps = i + 1
    launches = {k: v for k, v in read_counts().items() if v}
    want = {**block_launches(model, steps, steps), "ctc_alpha": steps, "ctc_beta": steps}
    model.load_params(state.params)
    with torch.no_grad():
        decoded = greedy_ctc_decode(model(F.one_hot(batch["signal"].long(), LEVELS).float()))
    truth = labels2strings([fx["labels"][b, :fx["label_lengths"][b]]
                            for b in range(len(fx["labels"]))])
    problems = [what for what, bad in (
        (f"never crossed per-char CTC {OVERFIT_CROSS} (last {per_char})", crossed is None),
        (f"greedy decode {decoded} != the bases {truth}", decoded != truth),
        (f"launches {launches} != {want}", launches != want)) if bad]
    if problems:
        raise AssertionError("(b) real-read overfit: " + "; ".join(problems))
    log(f"(b) real-read overfit on the card (float32, {len(layers)} + {2 * len(layers)} blocks at "
        f"C={OVERFIT_C}, Adam {OVERFIT_LR}, B={batch['signal'].shape[0]} L={frames}): "
        f"per-char CTC below {OVERFIT_CROSS} at step {crossed}, {steps} steps to "
        f"{per_char:.4f} (< {OVERFIT_STOP}); greedy decode equals the read's bases; "
        f"launches {launches}; B4, B5 at C={OVERFIT_C} within phases 1/5's "
        f"tolerances, max_abs_err {f_err:.3e}, {b_err:.3e}")


def ecoli_cfg(path, run_dir):
    """configs/ecoli_hdf5_quality.json as it stands but for the read set,
    the run directory, 20 steps a run, a print and a checkpoint every 10,
    and 4 batches an evaluate."""
    cfg = json.loads(ECOLI_CONFIG.read_text())
    cfg["training"].update(training_data=str(path), save_dir=str(run_dir),
                           max_iters=ECOLI_STEPS, print_every=ECOLI_PRINT,
                           save_every=ECOLI_PRINT, eval_batches=ECOLI_EVAL_BATCHES)
    return cfg


def producers():
    """The live QueueLoader producer threads (named after their target)."""
    return [t for t in threading.enumerate() if "(_producer)" in t.name]


def recording_fetch(rec):
    """Dataset.fetch with each call appended to rec as (stream, the batch or
    None on StopIteration)."""
    fetch = Dataset.fetch

    def recorded(ds, stream="train"):
        try:
            batch = fetch(ds, stream)
        except StopIteration:
            rec.append((stream, None))
            raise
        rec.append((stream, batch))
        return batch

    return mock.patch.object(Dataset, "fetch", recorded)


def ecoli_train_runs(cfg, run_dir, dev):
    """(c) cli.train_with_result on the config twice on one run directory:
    20 steps, then resumed at 20 to 40. K=5 steps a call on (5, 8, 1216)
    int32 levels, B4-bf16 31 times (15 causal blocks, 16 centred) a train
    step and a validation forward (4 fixed batches a print), B5-bf16 31
    times a train step, B1 and B2
    once a step (B1 once a validation forward); no StopIteration before
    max_iters, and no producer thread alive after either run."""
    t = cfg["training"]
    stacked = ((t["steps_per_call"], t["batch_size"], t["pad_to"]), "int32")
    to_device = cli.batch_to_device
    for run, (start, end) in enumerate(((0, ECOLI_STEPS), (ECOLI_STEPS, 2 * ECOLI_STEPS)), 1):
        logged = len(read_jsonl(run_dir / "logs" / "metrics.jsonl")) if run > 1 else 0
        fetched, copied = [], []

        def recorded_copy(b, d):
            copied.append((b.signal.shape, str(b.signal.dtype)))
            return to_device(b, d)

        reset_counts()
        with recording_fetch(fetched), mock.patch.object(cli, "batch_to_device", recorded_copy):
            result = cli.train_with_result(copy.deepcopy(cfg), dev)
        torch.cuda.synchronize()
        run_counts = {k: v for k, v in read_counts().items() if v}
        lines = read_jsonl(run_dir / "logs" / "metrics.jsonl")[logged:]
        steps, valid = end - start, len(lines) * t["fixed_valid_batches"]
        want = {**cfg_block_launches(cfg, steps + valid, steps, bf16=True),
                "ctc_alpha": steps + valid, "ctc_beta": steps}
        train = [b for s, b in fetched if s == "train"]
        served = [i for i, b in enumerate(train) if b is not None]
        early = [i for i, b in enumerate(train) if b is None and i < steps]
        want_copies = {stacked: steps // t["steps_per_call"],
                       (stacked[0][1:], "int32"): t["fixed_valid_batches"]}
        got_copies = {k: copied.count(k) for k in set(copied)}
        messages = (run_dir / "logs" / "messages.log").read_text()
        ckpts = sorted(int(p.name) for p in (run_dir / "ckpts").iterdir() if p.name.isdigit())
        losses = [v for l in lines for v in (l["train_loss"], l["valid_loss"])]
        problems = [what for what, bad in (
            (f"steps {result['steps']} != {end}", result["steps"] != end),
            (f"launches {run_counts} != {want}", run_counts != want),
            (f"copies to the card {got_copies} != {want_copies}", got_copies != want_copies),
            (f"{len(early)} StopIterations before max_iters", bool(early)),
            (f"{len(served)} train batches served", len(served) != steps),
            (f"non-finite losses {losses}", not all(map(math.isfinite, losses))),
            (f"{len(lines)} log lines", len(lines) != steps // ECOLI_PRINT),
            (f"checkpoints {ckpts}", ckpts != list(range(ECOLI_PRINT, end + 1, ECOLI_PRINT))),
            (f"producer threads alive {producers()}", bool(producers())),
            (f"did not resume at step {ECOLI_STEPS}", run > 1 and
             f"resumed from {run_dir}/ckpts/ @ step {ECOLI_STEPS}" not in messages))
            if bad]
        if problems:
            raise AssertionError(f"(c) train, run {run}: " + "; ".join(problems))
        log(f"(c) train run {run}: steps {start + 1}-{end}; copies to the card {got_copies}; "
            f"losses "
            + ", ".join(f"step {l['step']} train {l['train_loss']:.4f} valid "
                        f"{l['valid_loss']:.4f}" for l in lines)
            + f"; launches {run_counts}; checkpoints {ckpts}; StopIterations before max_iters "
            f"0; producer threads alive after the run 0")


def levels_equal_onehot(step, state, b, dev):
    """(d) one bf16 step on a levels batch and one on its host one-hot, from
    one state: the same metrics and updated params, to the bit."""
    onehot = Batch(np.eye(LEVELS, dtype=np.float32)[b.signal], b.labels, b.label_lengths,
                   b.signal_lengths)
    (sa, ma), (sb, mb) = (step(state, batch_to_device(x, dev)) for x in (b, onehot))
    leaves = [(x, y) for x, y in zip(tree_leaves((sa.params, sa.opt_state)),
                                     tree_leaves((sb.params, sb.opt_state)))]
    differ = [k for k in ma if not torch.equal(ma[k], mb[k])] + \
        [f"{sum(not torch.equal(x, y) for x, y in leaves)} state leaves"] * \
        any(not torch.equal(x, y) for x, y in leaves)
    if differ:
        raise AssertionError(f"(d) the levels step and the one-hot step differ: {differ}")
    log(f"(d) one bf16 step on (8, 1216) int32 levels and one on its host one-hot "
        f"{onehot.signal.shape}: metrics and the {len(leaves)} params and Adam leaves "
        f"equal to the bit (total_loss {float(ma['total_loss']):.6f})")


def ecoli_evaluate(cfg, run_dir, dev):
    """(e) The evaluate command on (c)'s run, decoder beam W=7, 4 held-out
    batches (captured as evaluate draws them: 4 producers do not fix their
    order): B6 once a batch; the printed loss equal to the eval step on
    those batches, the identity to that of beam_search_ref's decode of the
    same one-hot forward, to which B6 is held row for row; the loader's
    threads closed."""
    path = run_dir / "evaluate.json"
    path.write_text(json.dumps(cfg))
    drawn, buf = [], io.StringIO()
    reset_counts()
    with recording_fetch(drawn), contextlib.redirect_stdout(buf):
        rc = cli.main(["evaluate", str(path)])
    launches = {k: v for k, v in read_counts().items() if v}
    alive = producers()
    line = buf.getvalue().strip().splitlines()[-1]
    m = re.match(r"eval loss over (\d+) batches: (\S+) \| basecall identity: (\S+)$", line)
    if rc != 0 or not m:
        raise AssertionError(f"(e) evaluate: rc {rc}, output {buf.getvalue()!r}")
    batches = [b for _, b in drawn if b is not None]
    ds, model, state, _, eval_fn, _ = cli.build_from_config(copy.deepcopy(cfg), dev)
    ds.close()
    state = restore_checkpoint(str(run_dir / "ckpts"), state)
    model.load_params(state.params)
    losses, ids, err = [], [], 0.0
    for b in batches:
        batch = batch_to_device(b, dev)
        losses.append(float(eval_fn(state.params, batch)["total_loss"]))
        with torch.no_grad():
            logits = model(F.one_hot(batch["signal"].long(), LEVELS).float())
        lengths = torch.as_tensor(model.output_length(b.signal_lengths), dtype=torch.int32,
                                  device=dev)
        lp = torch.log_softmax(logits.float(), -1)
        kw = dict(beam_width=BEAM_WIDTH, max_label_len=lp.shape[1])
        want = beam_finalize(beam_search_ref(lp, lengths, **kw))
        _, e = compare_beams(beam_finalize(beam_search_kernel(lp, lengths, **kw)), want,
                             BEAM_WIDTH)
        err = max(err, e)
        targets = labels2strings([b.labels[r, :b.label_lengths[r]] for r in range(len(b.labels))])
        decoded = labels2strings([want[0][r, 0, :int(want[1][r, 0])].cpu().numpy()
                                  for r in range(len(b.labels))])
        ids.append(batch_identity([list(d) for d in decoded], targets)[0])
        shape = f"B={lp.shape[0]} T={lp.shape[1]} C={lp.shape[2]} W={BEAM_WIDTH}"
    n = ECOLI_EVAL_BATCHES
    want_launches = {**add_counts(block_launches(model, n, bf16=True), block_launches(model, n)),
                     "ctc_alpha": n, "ctc_beam": n}
    want_loss, want_ident = float(np.mean(losses)), f"{np.mean(ids):.3f}"
    problems = [what for what, bad in (
        (f"{m[1]} batches, {len(batches)} drawn", int(m[1]) != n or len(batches) != n),
        (f"launches {launches} != {want_launches}", launches != want_launches),
        (f"loss {m[2]} != the eval step's {want_loss:.6f}",
         abs(float(m[2]) - want_loss) > EVAL_LOSS_ATOL + 1e-6 * abs(want_loss)),
        (f"identity {m[3]} != the plain decode's {want_ident}", m[3] != want_ident),
        (f"producer threads alive {alive}", bool(alive))) if bad]
    if problems:
        raise AssertionError("(e) evaluate: " + "; ".join(problems))
    log(f"(e) evaluate, decoder beam W={BEAM_WIDTH}: {line!r}; launches {launches} (the eval "
        f"step in bf16, the decode's forward in float32); the eval step recomputed "
        f"{want_loss:.6f}, the identity of beam_search_ref's decode {want_ident}; B6 at "
        f"{shape}: every live row equal to beam_search_ref's (max score error {err:.3e}); "
        f"producer threads alive after it 0")


def run_hdf5(dev):
    """Phase 11: the HDF5 read path. (a) the real-read fixture rebuilt,
    (b) the overfit on it, then on a read set of 8 reads x 4000 events:
    (c) configs/ecoli_hdf5_quality.json through train and a resume, B4/B5-bf16
    held at its 15 blocks, B1/B2 at its length-aware CTC, (d) levels against
    one-hot, (e) evaluate."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_hdf5_"))
    try:
        overfit_realread(dev, rebuild_fixture(tmp))
        path, run_dir = tmp / "ecoli_reads.hdf5", tmp / "run"
        cfg = ecoli_cfg(path, run_dir)
        with reads_file(path, make_reads(SEED, ECOLI_READS, ECOLI_EVENTS)) as how:
            log(f"phase 11 read set: {ECOLI_READS} reads x {ECOLI_EVENTS} events at {LEVELS} "
                f"levels, 4-11 samples an event ({how}); configs/ecoli_hdf5_quality.json: "
                f"{len(cfg['model']['base']['dilations'])} + "
                f"{len(cfg['model']['classifier']['dilations'])} blocks, pool "
                f"{cfg['model']['classifier']['downsample']}, bf16, nworkers "
                f"{cfg['training']['nworkers']}, steps_per_call "
                f"{cfg['training']['steps_per_call']}, {ECOLI_STEPS} steps a run")
            ecoli_train_runs(cfg, run_dir, dev)
            # the kernels at this path's shapes, on one held-out levels batch
            ds, model, state, (step, *_), _, t = cli.build_from_config(copy.deepcopy(cfg), dev)
            try:
                b = ds.fetch("valid")
            finally:
                ds.close()
            state = restore_checkpoint(str(run_dir / "ckpts"), state)
            model.load_params(state.params)
            batch = batch_to_device(b, dev)
            check_cli_kernels(model, batch, t)
            with torch.no_grad():
                logits = model(F.one_hot(batch["signal"].long(), LEVELS).float())
            frames = torch.as_tensor(model.output_length(b.signal_lengths), dtype=torch.int32,
                                     device=dev)
            ext, allow = _extend_labels(batch["labels"], 0)
            lp_ext = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
            T, Bx, J = lp_ext.shape
            log(f"(c) B1, B2 at the length-aware CTC: B={Bx} T={T} J={J}, logit lengths "
                f"{frames.tolist()}")
            phase_ctc(lp_ext, torch.where(allow, 0.0, NEG), logits, batch, frames)
            levels_equal_onehot(step, state, b, dev)
            del model, state, step, logits, lp_ext
            ecoli_evaluate(cfg, run_dir, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- 12. the quality harness: examples/gaussian_eval.py at full width ---------

ROOT = Path(__file__).resolve().parent
HARNESS = "wavenet_speech_tpu_torch.examples.gaussian_eval"
BISECT = "wavenet_speech_tpu_torch.tools.bisect_nonfinite"
# the reference's eval architecture (2048 features, fk 3, 100 non-causal
# blocks of 512 channels, 50 at k=2 and 50 at k=3, out 512, 5 labels),
# Adamax 2e-4, batch_standardize, CTC per logit, float32
QUALITY_WIDTH = ("--scale", "1.0", "--nhid", "512")
QUALITY_STEPS, QUALITY_SAVE, QUALITY_EVAL_BATCHES = 20, 10, 2
# the harness's CTC against the plain CTC on the same logits; the native
# engine's scores (double) against B6's (float32)
QUALITY_CTC_RTOL = NATIVE_SCORE_RTOL = 1e-5
# forensics: where out1.w x 1e30 may first go non-finite (at or after out1;
# tests/test_diagnostics.py)
AFTER_OUT1 = ("out1", "logits", "ctc_per_seq", "loss", "global_norm_sumsq")
SMOKE_PRINTS = (0, 50, 100)


def run_module(module, args, what):
    """``python -m module args`` from the checkout's root, as a user runs
    it (on this card, a process of its own); returns its stdout."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise AssertionError(f"{what}: python -m {module} exited {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def harness_args(ckpt_dir, out, steps, *extra):
    return [*QUALITY_WIDTH, "--steps", str(steps), "--save-every", str(QUALITY_SAVE),
            "--eval-batches", str(QUALITY_EVAL_BATCHES), "--ckpt-dir", str(ckpt_dir),
            "--out", str(out), *extra]


def step_dirs(ckpt_dir):
    return sorted(int(p.name) for p in Path(ckpt_dir).iterdir() if p.name.isdigit())


def ctc_prints(text):
    return {int(m[1]): float(m[2])
            for m in re.finditer(r"^step (\d+): per-logit CTC (\S+)", text, re.M)}


def quality_train_runs(tmp):
    """(a) The main path: a straight 20-step run into D1 in this process
    (launches counted), then 10 steps into D2, D2 resumed to 20 and
    --eval-only on D2, each ``python -m`` the harness. The step-20
    checkpoints of D1 and D2 equal to the bit, the three result JSONs
    equal, max_to_keep's directories. Returns D1's result and its
    checkpoint directory."""
    d1, d2 = tmp / "d1" / "ckpts", tmp / "d2" / "ckpts"
    out = {k: tmp / f"{k}.json" for k in ("d1", "d2_10", "d2", "d2_eval")}
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        r1 = gaussian_eval.main(harness_args(d1, out["d1"], QUALITY_STEPS))
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    want = {"ctc_alpha": QUALITY_STEPS + QUALITY_EVAL_BATCHES, "ctc_beta": QUALITY_STEPS,
            "ctc_beam": QUALITY_EVAL_BATCHES, **block_launches(
                gaussian_eval.build_model(float(QUALITY_WIDTH[1]), nhid=int(QUALITY_WIDTH[3]),
                                          device="meta"),
                QUALITY_STEPS + QUALITY_EVAL_BATCHES, QUALITY_STEPS)}
    if launches != want:
        raise AssertionError(f"(a) D1: launches {launches}, expected {want}")
    run_module(HARNESS, harness_args(d2, out["d2_10"], QUALITY_SAVE), "(a) D2, 10 steps")
    text = run_module(HARNESS, harness_args(d2, out["d2"], QUALITY_STEPS), "(a) D2, resumed")
    text_e = run_module(
        HARNESS, harness_args(d2, out["d2_eval"], QUALITY_STEPS, "--eval-only"),
        "(a) D2, --eval-only")
    results = [json.loads(json.dumps(r1))] + [json.loads(out[k].read_text())
                                              for k in ("d1", "d2", "d2_eval")]
    a, b = (torch.load(d / str(QUALITY_STEPS) / "state.pt", map_location="cpu",
                       weights_only=True) for d in (d1, d2))
    la, lb = tree_leaves(a), tree_leaves(b)
    differ = sum(not (torch.equal(x, y) if torch.is_tensor(x) else x == y)
                 for x, y in zip(la, lb))
    dirs = {"D1": step_dirs(d1), "D2": step_dirs(d2)}
    want_dirs = list(range(QUALITY_SAVE, QUALITY_STEPS + 1, QUALITY_SAVE))
    problems = [what for what, bad in (
        (f"step-20 checkpoints differ in {differ} of {len(la)} leaves",
         differ or len(la) != len(lb)),
        ("the result JSONs differ", any(r != results[0] for r in results)),
        (f"step directories {dirs}, expected {want_dirs}",
         any(v != want_dirs for v in dirs.values())),
        ("D2 did not resume at step 10", f"resumed from step {QUALITY_SAVE}" not in text),
        ("--eval-only did not restore step 20",
         f"resumed from step {QUALITY_STEPS}" not in text_e),
        ("a non-finite number in the result",
         not all(map(math.isfinite, [r1["avg_per_logit_ctc"], r1["mean_identity"]]))))
        if bad]
    if problems:
        raise AssertionError("(a) " + "; ".join(problems))
    n = sum(t.numel() for t in a["params"].values())
    log(f"(a) the harness at full width ({len(a['params'])} parameter tensors, {n} "
        f"parameters): D1 20 steps in this process, per-logit CTC at step 0 "
        f"{ctc_prints(buf.getvalue())[0]:.4f}; launches {launches}; D2 10 steps, resumed "
        f"to 20, --eval-only: step-20 checkpoints of D1 and D2 equal to the bit ({len(la)} "
        f"leaves: params, Adamax's state, step); the three result JSONs equal; step "
        f"directories {dirs} (max_to_keep 4, final save max_to_keep 2)")
    log(f"(a) result: {json.dumps(r1)}")
    return r1, d1


def quality_batch_inputs(net, params, batch):
    """The eval forward's logits and what B1 gets from them: the extended
    log-probs (T, B, J) and the skip mask."""
    with torch.no_grad():
        logits = torch.func.functional_call(net, params, (batch_standardize(batch["signal"]),))
    ext, allow = _extend_labels(batch["labels"], 0)
    lp_ext = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
    return logits, lp_ext, torch.where(allow, 0.0, NEG)


def quality_eval_recompute(net, params, r1):
    """(b) D1's evaluation recomputed from its step-20 params on the same
    held-out batches: the per-logit CTC on the plain CTC within
    QUALITY_CTC_RTOL; B6's beams row for row equal to the plain beam's; the
    native engine's best paths and times equal to B6's, its scores within
    NATIVE_SCORE_RTOL; the identities from those decodes equal to the
    JSON's. B1/B2 at this shape against their plain versions (phase_ctc)."""
    args = gaussian_eval.parse_args([*QUALITY_WIDTH])
    train = gaussian_eval.make_loader(args, gaussian_eval.TRAIN_SEED)
    ev = gaussian_eval.make_loader(args, gaussian_eval.EVAL_SEED, train.pad_to,
                                   train.labels_pad_to)
    dev = next(iter(params.values())).device
    plain_ctc, idents, b6_err, live_rows, native_err = [], [], 0.0, 0, 0.0
    for i in range(QUALITY_EVAL_BATCHES):
        b = ev.fetch()
        batch = batch_to_device(b, dev)
        logits, lp_ext, skip = quality_batch_inputs(net, params, batch)
        Bx, T = logits.shape[:2]
        full = torch.full((Bx,), T, dtype=torch.int32, device=dev)
        with torch.no_grad(), ctc_plain():
            plain_ctc.append(float(ctc_loss_per_seq(logits, full, batch["labels"],
                                                    batch["label_lengths"]).sum()) / T)
        S = int(b.label_lengths.max() * 2)
        lp = torch.log_softmax(logits.float(), -1)
        kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
        got = beam_finalize(beam_search_kernel(lp, full, **kw))
        want = beam_finalize(beam_search_ref(lp, full, **kw))
        live, err = compare_beams(got, want, BEAM_WIDTH)
        b6_err, live_rows = max(b6_err, err), live_rows + live
        nl, nn, ns, nt = ctc_beam_search_native(logits.cpu().numpy(), beam_width=BEAM_WIDTH,
                                                max_label_len=S, return_times=True)
        preds = []
        for r in range(Bx):
            n = int(got[1][r, 0])
            best, times = got[0][r, 0, :n].cpu().numpy(), got[3][r, 0, :n].cpu().numpy()
            if int(nn[r]) != n or not (np.array_equal(nl[r, :n], best)
                                       and np.array_equal(nt[r, :n], times)):
                raise AssertionError(f"(b) batch {i} read {r}: the native engine's best path "
                                     f"or times differ from B6's")
            native_err = max(native_err, abs(float(ns[r]) - float(got[2][r, 0]))
                             / abs(float(got[2][r, 0])))
            preds.append(best)
        truths = [b.labels[r, :b.label_lengths[r]] for r in range(Bx)]
        idents.extend(d[0] for d in batch_identity(preds, truths)[1])
        if i == 0:
            shape = f"B={Bx} T={T} J={lp_ext.shape[2]} S={S}"
            phase_ctc(lp_ext, skip, logits, batch)
    ctc_rel = abs(float(np.mean(plain_ctc)) - r1["avg_per_logit_ctc"]) / r1["avg_per_logit_ctc"]
    problems = [what for what, bad in (
        (f"avg_per_logit_ctc {r1['avg_per_logit_ctc']} against the plain CTC's "
         f"{np.mean(plain_ctc)} (relative {ctc_rel:.2e})", ctc_rel > QUALITY_CTC_RTOL),
        (f"native scores {native_err:.2e} apart from B6's", native_err > NATIVE_SCORE_RTOL),
        (f"mean_identity {r1['mean_identity']} != {np.mean(idents)} recomputed",
         float(np.mean(idents)) != r1["mean_identity"]),
        ("identities differ", [round(float(x), 3) for x in idents] != r1["identities"]))
        if bad]
    if problems:
        raise AssertionError("(b) " + "; ".join(problems))
    log(f"(b) the evaluation recomputed on D1's step-20 params, {QUALITY_EVAL_BATCHES} "
        f"batches at {shape}: per-logit CTC on the plain CTC {np.mean(plain_ctc):.6f} "
        f"(relative {ctc_rel:.2e} from the JSON's, bound {QUALITY_CTC_RTOL}); B6's "
        f"{live_rows} live rows equal to the plain beam's (max score error {b6_err:.3e}); "
        f"the native engine's best paths and times equal to B6's, scores within "
        f"{native_err:.2e} relative (bound {NATIVE_SCORE_RTOL}); mean_identity "
        f"{np.mean(idents):.6f} recomputed from those decodes")


def quality_forensics(params, b, tmp):
    """(c) D1's trained params with out1.w x 1e30 (tests/test_diagnostics.py)
    dumped with dump_anomaly, then ``python -m`` the bisect tool on the
    card: its verdict names sites at or after out1 only, every stage before
    out1 is finite, and the probed forward matches the model's in bf16 and
    float32."""
    bad = dict(params, **{"out1.w": params["out1.w"] * 1e30})
    path = dump_anomaly(str(tmp / "anomalies"), b, bad, QUALITY_STEPS, "nonfinite",
                        {"ctc_loss": float("nan"), "grad_norm": float("nan")})
    out = tmp / "bisect.json"
    run_module(BISECT, ["--dump", path, *QUALITY_WIDTH, "--out", str(out)],
               "(c) bisect_nonfinite")
    rep = json.loads(out.read_text())
    sites = re.findall(r"'([^']+)'", rep["verdict"])
    problems = [what for what, bad_ in (
        (f"verdict {rep['verdict']!r} names no site at or after out1",
         not sites or not all(s in AFTER_OUT1 or s.startswith("grad:") for s in sites)),
        *((f"{d}: the probed forward differs from the model's",
           not rep["reports"][d]["probe_matches_model_apply"]) for d in ("bf16", "f32")),
        *((f"{d}: stage {name} before out1 is non-finite", not finite)
          for d in ("bf16", "f32")
          for name, finite, _ in itertools.takewhile(lambda st: st[0] != "out1",
                                                     rep["reports"][d]["stages"])))
        if bad_]
    if problems:
        raise AssertionError("(c) " + "; ".join(problems))
    log(f"(c) bisect_nonfinite on D1's params with out1.w x 1e30 (a process of its own): "
        f"VERDICT {rep['verdict']}; probe == model forward in bf16 and float32")


def quality_smoke(tmp):
    """(d) The --smoke preset's 150 steps on the card: the per-logit CTC at
    steps 0, 50 and 100 must fall, the result JSON be finite."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = gaussian_eval.main(["--smoke", "--out", str(tmp / "smoke.json")])
    ctc = ctc_prints(buf.getvalue())
    numbers = [r["avg_per_logit_ctc"], r["ref_convention_per_logit_ctc"],
               r["mean_identity"], *r["identities"]]
    if sorted(ctc) != list(SMOKE_PRINTS) or not ctc[SMOKE_PRINTS[-1]] < ctc[0] \
            or not all(map(math.isfinite, numbers)):
        raise AssertionError(f"(d) --smoke: per-logit CTC {ctc}, result {r}")
    log(f"(d) --smoke (scale 1/64, 10 blocks of 32 channels, batch 4, lr 2e-3, 150 steps) on "
        f"the card: per-logit CTC " + ", ".join(
            f"step {s} {v:.4f}" for s, v in ctc.items()) + f"; result {json.dumps(r)}")


def run_quality(dev):
    """Phase 12: the quality harness (examples/gaussian_eval.py) at the
    reference's full width: train, resume, evaluate, forensics, the --smoke
    preset."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_"))
    try:
        # ---- (a) the main path: train, resume, re-evaluate
        r1, d1 = quality_train_runs(tmp)
        net = gaussian_eval.build_model(1.0, nhid=512, device=dev)
        params = {k: v.to(dev) for k, v in torch.load(
            d1 / str(QUALITY_STEPS) / "state.pt", map_location="cpu",
            weights_only=True)["params"].items()}
        # ---- (b) the evaluation against its recomputation
        quality_eval_recompute(net, params, r1)
        # ---- (c) forensics on poisoned params
        args = gaussian_eval.parse_args([*QUALITY_WIDTH])
        quality_forensics(params, gaussian_eval.make_loader(
            args, gaussian_eval.TRAIN_SEED).fetch(), tmp)
        del net, params
        torch.cuda.empty_cache()
        # ---- (d) the --smoke preset
        quality_smoke(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- 13. the rest of multi-device: TP, RawCTCNet under SP, BatchNorm over DP, the
# CTC step on a mesh, the distributed decoders -------------------------------------

DRYRUN_RANKS = 8
# (a): the launches of each dry-run check on every rank (graft_entry's
# module docstring): B4/B5 at the SP+TP joint step's 10 causal and 7 centred
# blocks and at RawCTCNet's 11 centred ones under SP, B3 for every
# sequence-sharded CTC, B4/B5 at the 7 centred blocks of the DP+TP step's
# flagship and B1/B2, B6 once a decode
DRYRUN_LAUNCHES = {
    "joint": {"fused_gated_block": 17, "fused_gated_block_bwd": 17,
              "fused_gated_block_centred": 7, "ctc_alpha_segment": 1, "ctc_beta_segment": 1},
    "raw": {"fused_gated_block": 11, "fused_gated_block_bwd": 11,
            "fused_gated_block_centred": 11, "ctc_alpha_segment": 1, "ctc_beta_segment": 1},
    "ctc": {"ctc_alpha_segment": 1, "ctc_beta_segment": 1},
    "step": {"fused_gated_block": 7, "fused_gated_block_bwd": 7,
             "fused_gated_block_centred": 7, "ctc_alpha": 1, "ctc_beta": 1},
    "decode": {"ctc_beam": 1}, "seq_decode": {"ctc_beam": 1}}
MULTI_RANKS = 2
# (b)-(d): a rank's launches a step (the pair, TP) or a decode, besides the
# fused blocks' (every block of the pair: block_launches)
PAIR_LAUNCHES = {"data": {"ctc_alpha": 1, "ctc_beta": 1},
                 "seq": {"ctc_alpha_segment": 1, "ctc_beta_segment": 1}}
PAIR_HELD = {"data": {"ctc_alpha", "ctc_beta"}, "seq": {"B3-fwd", "B3-bwd"}}
TP_LAUNCHES = {"ctc_alpha": 1, "ctc_beta": 1}
DECODE_LAUNCHES = {"ctc_beam": 1}
# (b): the 512-feature pair on (data 2) and (seq 2) against one device:
# the same sums in another order (the gradients summed over two ranks,
# shorter shards; BatchNorm's statistics are summed in float64, equal to the
# bit). On the card one float32 device's gradients are 1e-4 (the depth cut
# to PAIR_CUT_BLOCKS cycles) to 2.4e-3 (full depth) from float64's in
# relative norm at the first step, more at the next (the first update lands
# the untrained pair on a loss spike, 3.37 -> 24.9, as phase 10 (d)), so
# phase 8's fixed bounds are printed, not held: each step's loss,
# gradient tree and worst gradient leaf on the mesh are held within
# SENS_FACTOR x one float32 device's distance (its loss, tree, worst leaf)
# from the same steps in float64 (at least those bounds), as phase 8 (c)
# holds its full depth to the cuDNN composite's distance. The running
# statistics after 3 steps at 1e-5.
PAIR_LOSS_RTOL, PAIR_LEAF_RTOL, PAIR_STATS_RTOL = 1e-5, 1e-4, 1e-5
PAIR_CUT_BLOCKS = 1


class BeamRecorder(Recorder):
    """A Recorder of B6 (called with keywords): each call's (log-probs,
    lengths, keywords, the raw state it returned)."""

    def __call__(self, lp, lengths, **kw):
        out = self.fn(lp, lengths, **kw)
        self.calls.append((lp.detach().clone(), lengths.clone(), dict(kw), out))
        return out


@contextlib.contextmanager
def record_beam(calls):
    """Record every B6 launch, whichever module calls it (its launch count
    stays the kernel's: the recorder forwards attributes)."""
    from wavenet_speech_tpu_torch.decoding import distributed as dist_decode

    rec = BeamRecorder(beam_search_kernel, calls)
    with mock.patch.object(ctc_beam_device, "beam_search_kernel", rec), \
            mock.patch.object(dist_decode, "beam_search_kernel", rec):
        yield calls


def hold_recorded(rec, beams, label):
    """Every recorded CTC call (B3 with its carry and t_offset; B1/B2)
    against the plain loops on the same inputs, every B6 launch against its
    plain version from the same state (finalized beams: prefixes, lengths,
    times equal, scores within BEAM_SCORE_ATOL). Returns each kernel's max
    error and calls held, by its name on the kernels line."""
    err = {}

    def note(name, e):
        k = err.setdefault(name, {"err": 0.0, "n": 0})
        k["err"], k["n"] = max(k["err"], e), k["n"] + 1

    for fa, out in rec["fwd"]:
        want = ctc_fwd_ref(*fa)
        note("B3-fwd" if len(fa) > 5 else "ctc_alpha",
             max(check_close(f"{label} CTC fwd {name}", g, w, CTC_RTOL, CTC_ATOL)
                 for name, g, w in zip(("ll", "alphas", "alpha_out"), out, want)))
    for ba, (grad, lpb_out) in rec["bwd"]:
        want = ctc_bwd_ref(*ba)
        note("B3-bwd" if len(ba) > 7 else "ctc_beta",
             max(check_close(f"{label} CTC bwd grad", grad, want[0], CTC_GRAD_RTOL,
                             CTC_GRAD_ATOL),
                 check_close(f"{label} CTC bwd lpb_out", lpb_out, want[1], CTC_RTOL,
                             CTC_ATOL)))
    for lp, lengths, kw, state in beams:
        state_in = kw.get("state")
        want = beam_search_ref(lp, lengths, **dict(kw, state=None if state_in is None else
                                                   tuple(x.clone() for x in state_in)))
        note("ctc_beam", compare_beams(beam_finalize(state), beam_finalize(want),
                                       kw["beam_width"])[1])
    return err


def merge_held(*helds):
    """Several hold_recorded / hold_blocks results as one: each kernel's
    max error and its calls summed."""
    out = {}
    for held in helds:
        for name, k in held.items():
            o = out.setdefault(name, {"err": 0.0, "n": 0})
            o["err"], o["n"] = max(o["err"], k["err"]), o["n"] + k["n"]
    return out


def joint_shim(inp, mesh):
    """The dry run's joint models with its whole params, as capture_blocks
    takes a model, and its joint batch sharded over the mesh."""
    dev = mesh.device
    wn, clf = graft_entry._joint_models(dev)
    params = tree_map(lambda t: t.to(dev), inp["joint_params"])
    batch = shard_batch(mesh, {k: torch.as_tensor(v).to(dev)
                               for k, v in inp["joint_batch"].items()}, seq_keys=("signal",))
    return types.SimpleNamespace(params=lambda: tree_map(torch.clone, params),
                                 model_base=wn, model_ctc=clf), batch


def dryrun13_rank(shape, inp, device):
    """(a) One rank of graft_entry.dryrun_multichip (module-level: run_ranks
    spawns it): its checks with every CTC and beam call recorded, then held
    against their plain versions; B4 and B5 against the kernels' arithmetic
    at each block of the joint check on this rank's halo window; the joint
    check again with the plain blocks."""
    with record_ctc() as rec, record_beam([]) as beams:
        out = graft_entry.dryrun_rank(shape, inp, device)
    check_numerics(f"dry-run rank {dist.get_rank()}")
    held = hold_recorded(rec, beams, "(a)")
    del rec, beams
    data, model, seq = shape
    mesh = make_mesh(data=data, model=model, seq=seq, device=device)
    shim, batch = joint_shim(inp, mesh)
    out["blocks"] = check_blocks(capture_blocks(shim, batch, None, JointLoss("joint"),
                                                None, mesh))
    b = out["blocks"]
    out["held"] = merge_held(held, {"fused_gated_block": {"err": b["b4_err"], "n": b["n"]},
                                    "fused_gated_block_bwd": {"err": max(b["b5_err"]),
                                                              "n": b["n"]}})
    with blocks_as(fused_gated_block_ref):
        out["joint_plain"] = graft_entry._joint(mesh.device, inp, mesh)
    return out


def joint_distances(got, one, exact):
    """The joint check's gradients: the largest ratio of an element's
    distance from one device's to JAX's elementwise tolerance (1e-6 +
    1e-4 |one|), and the largest over the leaves of got's max distance
    from float64 over one device's."""
    jax_ratio, f64_ratio = 0.0, 0.0
    for g, w, x in zip(tree_leaves(got), tree_leaves(one), tree_leaves(exact)):
        g, w, x = (t.detach().double().cpu() for t in (g, w, x))
        jax_ratio = max(jax_ratio, float(((g - w).abs() / (1e-6 + 1e-4 * w.abs())).max()))
        f64_ratio = max(f64_ratio, float((g - x).abs().max() / (w - x).abs().max()))
    return jax_ratio, f64_ratio


def run_dryrun(dev):
    """(a) The port's dryrun_multichip(8) on this card: (data 2, model 2,
    seq 2), every check held to one device (the joint check's gradients to
    float64), the launches of every check on every rank, B3 and B6 (and the
    DP+TP step's B1/B2) held to their plain versions on the inputs the
    checks fed them, B4 and B5 at the joint check's blocks; the joint
    check's gradients with the kernels and with the plain blocks against
    JAX's elementwise tolerance and against float64, beside one device's
    run of the same blocks."""
    res = graft_entry.dryrun_multichip(DRYRUN_RANKS, rank_program=dryrun13_rank)
    ranks, refs = res["ranks"], res["references"]
    for r, out in enumerate(ranks):
        got = {k: out[k]["launches"] for k in DRYRUN_LAUNCHES if k in out}
        if got != DRYRUN_LAUNCHES:
            raise AssertionError(f"(a) rank {r} launches {got}, expected {DRYRUN_LAUNCHES}")
    held = merge_held(*(r["held"] for r in ranks))
    if set(held) != {"fused_gated_block", "fused_gated_block_bwd", "ctc_alpha", "ctc_beta",
                     "B3-fwd", "B3-bwd", "ctc_beam"}:
        raise AssertionError(f"(a) kernels held {sorted(held)}")
    with blocks_as(fused_gated_block_ref):
        one_plain = graft_entry._joint(dev, graft_entry.inputs(res["shape"]))
    exact = refs["joint64"]["grads"]
    kern = [joint_distances(r["joint"]["grads"], refs["joint"]["grads"], exact) for r in ranks]
    plain = [joint_distances(r["joint_plain"]["grads"], one_plain["grads"], exact)
             for r in ranks]
    one_kern = max(float((a.double().cpu() - x.double()).abs().max())
                   for a, x in zip(tree_leaves(refs["joint"]["grads"]), tree_leaves(exact)))
    one_pl = max(float((a.double().cpu() - x.double()).abs().max())
                 for a, x in zip(tree_leaves(one_plain["grads"]), tree_leaves(exact)))
    log(f"(a) dryrun_multichip({DRYRUN_RANKS}) on 1 card ({DRYRUN_RANKS} gloo ranks): mesh "
        f"{res['shape']}, step mesh {ranks[0]['step_mesh']}; max errors against one device "
        f"{res['errors']}; launches a rank "
        f"{ {k: ranks[0][k]['launches'] for k in DRYRUN_LAUNCHES} } on every rank "
        f"(one device: {res['reference_launches']}); held to the plain versions on every "
        f"rank: " + ", ".join(f"{k} {v['n']} calls max_abs_err {v['err']:.3e}"
                              for k, v in held.items()))
    log_blocks("(a) rank 0, the joint check's halo windows", ranks[0]["blocks"])
    log(f"(a) the joint check's gradients on the (2, 2, 2) mesh against one device's (max over "
        f"the ranks): with the kernels, max |mesh - one| / (1e-6 + 1e-4 |one|) "
        f"{max(k[0] for k in kern):.2f} (JAX's elementwise bound is 1), the leaf's max "
        f"distance from float64 up to {max(k[1] for k in kern):.2f} x one device's (bound "
        f"{graft_entry.JOINT_SENS}); with the plain blocks (cuBLAS float32) on the mesh and on "
        f"one device, {max(k[0] for k in plain):.2f} and {max(k[1] for k in plain):.2f} x; "
        f"one device's largest distance from float64: kernels {one_kern:.3e}, plain blocks "
        f"{one_pl:.3e}")


def pair_steps(model, params, batch, mesh=None):
    """3 Adamax steps of the joint step (JointLoss("ctc")) on the
    raw-ctcnet pair, on one device or this rank's shard: the losses, each
    step's gradient tree as it reaches the optimizer, the final running
    mean and var, the first step's launches."""
    tx = build_optimizer("adamax", GAUSS_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("ctc"),
                                 mesh=mesh)
    grads, guarded = [], trainer._guarded_update

    def record(st, total, g, *rest):
        grads.append([t.clone() for t in tree_leaves(g)])
        return guarded(st, total, g, *rest)

    with mock.patch.object(trainer, "_guarded_update", record):
        state, hist, launches = train_steps(step, TrainState.create(params, tx), batch)
    return dict(losses=[h["total_loss"] for h in hist], grads=grads,
                stats=[state.params["base"][k] for k in ("mean", "var")], launches=launches)


def pair_on_mesh(dev, shape, batch_g):
    """(b) on this rank: the pair's 3 steps on one device (this rank alone)
    and on the mesh of this shape, with the depth cut to PAIR_CUT_BLOCKS
    cycles and at full width and depth, there also in float64 on one
    device. By step: the loss's relative error, the worst gradient leaf's
    ||g - g_1|| / ||g_1|| and its name, the whole tree's; the mesh's and
    one float32 device's distances from the float64 steps (the loss, the
    tree, the worst leaf). The running statistics' error after the 3
    steps; what is bit-equal; the launches; every CTC call of the mesh's
    steps held against its plain version."""
    mesh = make_mesh(data=shape[0], seq=shape[1], device=dev)
    out = {"mesh": repr(mesh)}
    for depth, blocks in (("cut", PAIR_CUT_BLOCKS), ("full", None)):
        _, model = gauss_model(dev, blocks)
        params = model.params()
        one = pair_steps(model, params, batch_g)
        with record_ctc() as rec:
            got = pair_steps(model, params, shard_batch(mesh, batch_g, seq_keys=("signal",)),
                             mesh)
        held = hold_recorded(rec, [], "(b)")
        del rec
        # the multi-tensor and block kernels take float32 (or bf16) alone: the
        # float64 steps run the guard's, the optimizer's and the blocks' plain
        # versions
        with plain_multi_tensor(), blocks_as(fused_gated_block_ref):
            f64 = pair_steps(model, tree_map(lambda t: t.double(), params),
                             dict(batch_g, signal=batch_g["signal"].astype(np.float64)))
        names = [n for part in ("base", "ctc") for n in params[part]]
        steps = []
        for k in range(TRAIN_STEPS):
            rel = lambda a, b: abs(a["losses"][k] - b["losses"][k]) / abs(b["losses"][k])
            leaves = leaf_rel_errs(got["grads"][k], one["grads"][k])
            worst = int(np.argmax(leaves))
            leaves64 = leaf_rel_errs(got["grads"][k], f64["grads"][k])
            one_leaves64 = leaf_rel_errs(one["grads"][k], f64["grads"][k])
            steps.append(dict(loss=rel(got, one), leaf=leaves[worst], leaf_name=names[worst],
                              tree=rel_err(got["grads"][k], one["grads"][k]),
                              loss64=rel(got, f64), one_loss64=rel(one, f64),
                              tree64=rel_err(got["grads"][k], f64["grads"][k]),
                              one_tree64=rel_err(one["grads"][k], f64["grads"][k]),
                              leaf64=max(leaves64), one_leaf64=max(one_leaves64),
                              leaf64_name=names[int(np.argmax(leaves64))]))
        stats = max(float(((a - b).abs() / b.abs()).max())
                    for a, b in zip(got["stats"], one["stats"]))
        bit = dict(losses=got["losses"] == one["losses"],
                   grads=all(torch.equal(a, b) for g, w in zip(got["grads"], one["grads"])
                             for a, b in zip(g, w)),
                   stats=all(torch.equal(a, b) for a, b in zip(got["stats"], one["stats"])))
        want = {**PAIR_LAUNCHES["seq" if shape[1] > 1 else "data"],
                **block_launches(model, 1, 1)}
        out[depth] = dict(steps=steps, stats=stats, bit=bit, launches=got["launches"],
                          want_launches=want, held=held,
                          one_launches=one["launches"], losses=got["losses"],
                          one_losses=one["losses"], running=[float(t) for t in got["stats"]])
        del model, one, got, f64
    return out


def tp_on_mesh(dev, ref_path, batch_g):
    """(c) on this rank: the harness's eval architecture (2048 features, 100
    blocks) through make_ctc_train_step with batch_standardize on (model
    2): 3 Adamax steps, this rank's slices against the single-device
    steps' (bit for bit)."""
    mesh = make_mesh(data=1, model=MULTI_RANKS, seq=1, device=dev)
    net = gaussian_eval.build_model(1.0, nhid=512, device="meta")
    whole = quality_params()
    specs = param_shardings(mesh, whole, model_parallel=True)
    local = shard_params(mesh, whole, model_parallel=True)
    p0 = local_slices(mesh, whole, specs)   # on the CPU
    del whole
    tx = build_optimizer("adamax", GAUSS_LR)
    state = TrainState.create(local, tx)
    step = make_ctc_train_step(net, tx, preprocess=batch_standardize, mesh=mesh)
    history, first = [], None
    for _ in range(TRAIN_STEPS):
        reset_counts()
        state, m = step(state, batch_g)
        first = first or {k: v for k, v in read_counts().items() if v}
        history.append({k: float(v) for k, v in m.items()})
    ref = torch.load(ref_path, map_location="cpu", mmap=True, weights_only=True)
    want = local_slices(mesh, ref["params"], specs)
    got = {k: v.cpu() for k, v in state.params.items()}
    bit = all(torch.equal(got[k], want[k]) for k in got)
    err = max(float((got[k] - want[k]).abs().max()) for k in got)
    update_err = rel_err([got[k] - p0[k] for k in got], [want[k] - p0[k] for k in got])
    return dict(mesh=repr(mesh), losses=[h["ctc_loss"] for h in history],
                gnorms=[h["grad_norm"] for h in history], launches=first, bit=bit, err=err,
                want_launches={**TP_LAUNCHES, **block_launches(net, 1, 1)},
                update_err=update_err, n_sharded=sum(s is not None for s in specs.values()),
                n_leaves=len(specs))


def decoders_on_mesh(dev, logits, lengths):
    """(d) on this rank: distributed_beam_decode on (data 2) and
    seq_sharded_beam_decode on (seq 2) of the whole batch's logits, B6 on
    every rank."""
    from wavenet_speech_tpu_torch.decoding import (distributed_beam_decode,
                                                   seq_sharded_beam_decode)
    out = {}
    for name, shape, fn in (("batch", (MULTI_RANKS, 1), distributed_beam_decode),
                            ("seq", (1, MULTI_RANKS), seq_sharded_beam_decode)):
        mesh = make_mesh(data=shape[0], seq=shape[1], device=dev)
        reset_counts()
        got = fn(mesh, logits, lengths, beam_width=BEAM_WIDTH)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if v}
        out[name] = dict(got=got, launches=launches, mesh=repr(mesh))
    return out


def multi13_rank(device, ref_path, pair_batch, logits, lengths, tp_batch):
    """(b)-(d) on one of MULTI_RANKS ranks of this card (module-level:
    run_ranks spawns it)."""
    dev = torch.device(device)
    out = {"pair": {name: pair_on_mesh(dev, shape, pair_batch)
                    for name, shape in (("data", (MULTI_RANKS, 1)), ("seq", (1, MULTI_RANKS)))}}
    out["decode"] = decoders_on_mesh(dev, logits, lengths)
    torch.cuda.empty_cache()
    out["tp"] = tp_on_mesh(dev, ref_path, tp_batch)
    check_numerics(f"multi-device rank {dist.get_rank()}")
    return out


def quality_params():
    """The harness's eval architecture's weights from its seed (CPU)."""
    net = gaussian_eval.build_model(1.0, nhid=512, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(gaussian_eval.TRAIN_SEED))
    return {k: v.detach() for k, v in net.state_dict().items()}


def tp_reference(dev, tmp):
    """(c) one device: the harness's step (make_ctc_train_step with
    batch_standardize, Adamax) from the seed, 3 steps, on the same batch;
    the final params saved for the ranks. Returns (the batch, the
    reference's numbers, the file)."""
    args = gaussian_eval.parse_args([*QUALITY_WIDTH])
    b = gaussian_eval.make_loader(args, gaussian_eval.TRAIN_SEED).fetch()
    batch = {k: getattr(b, k) for k in FIELDS}
    net = gaussian_eval.build_model(1.0, nhid=512, device="meta")
    tx = build_optimizer("adamax", GAUSS_LR)
    step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
    state = TrainState.create({k: v.to(dev) for k, v in quality_params().items()}, tx)
    dbatch = batch_to_device(b, dev)
    history = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, dbatch)
        history.append({k: float(v) for k, v in m.items()})
    path = tmp / "tp_reference.pt"
    torch.save({"params": {k: v.cpu() for k, v in state.params.items()}}, path)
    ref = dict(losses=[h["ctc_loss"] for h in history], gnorms=[h["grad_norm"] for h in history],
               B=b.signal.shape[0], L=b.signal.shape[1])
    del state, step, dbatch
    torch.cuda.empty_cache()
    return batch, ref, path


def run_multi(dev):
    """Phase 13: the rest of the multi-device path. (a) dryrun_multichip(8);
    (b)-(d) on 2 gloo ranks of this card, against single-device runs."""
    dev = resolve_device(dev)
    run_dryrun(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        tp_batch, ref, ref_path = tp_reference(dev, Path(tmp))
        # (b), (d): configs/gauss_quality.json's pair and a raw-gauss batch
        ds = Dataset("raw-gauss", batch_size=6, min_length=80, max_length=90, upsampling=6,
                     seed=SEED)
        b = ds.fetch("train")
        pair_batch = {k: getattr(b, k) for k in FIELDS}
        _, model = gauss_model(dev)
        with torch.no_grad():
            base = model.eval_base()(torch.from_numpy(b.signal).to(dev))
            logits = model.model_ctc(base)
        lengths = torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int32, device=dev)
        one = ctc_beam_search(logits, lengths, beam_width=BEAM_WIDTH, return_times=True)
        del model
        torch.cuda.empty_cache()
        ranks = run_ranks(multi13_rank, MULTI_RANKS, "gloo", str(dev), str(ref_path),
                          pair_batch, logits.cpu(), lengths.cpu(), tp_batch, timeout=900)
    # (b) the pair on (data 2) and (seq 2)
    for name in ("data", "seq"):
        for r, out in enumerate(ranks):
            p = out["pair"][name]
            for depth in ("cut", "full"):
                q = p[depth]
                log(f"(b) rank {r} {p['mesh']}: gauss_quality's pair (BatchNorm1d + RawCTCNet, "
                    f"512 features, fk 3, "
                    + (f"the depth cut to {PAIR_CUT_BLOCKS} x 5 + 1 blocks" if depth == "cut"
                       else "5 x 5 + 1 blocks")
                    + f"; JointLoss('ctc'), Adamax {GAUSS_LR}, B=6, L=486), 3 steps against one "
                    f"device, by step: " + "; ".join(
                        f"{k + 1}: loss rel {st['loss']:.2e}, worst leaf {st['leaf_name']} "
                        f"{st['leaf']:.2e}, tree {st['tree']:.2e}; from the float64 steps: "
                        f"loss {st['loss64']:.2e} (one device's {st['one_loss64']:.2e}), tree "
                        f"{st['tree64']:.2e} (one device's {st['one_tree64']:.2e}), worst leaf "
                        f"{st['leaf64_name']} {st['leaf64']:.2e} (one device's worst "
                        f"{st['one_leaf64']:.2e})"
                        for k, st in enumerate(q["steps"]))
                    + f"; running mean/var rel {q['stats']:.2e} (bound {PAIR_STATS_RTOL}); "
                    f"bit-equal {q['bit']}; CTC calls held to the plain loops: "
                    + ", ".join(f"{k} {v['n']} max_abs_err {v['err']:.3e}"
                                for k, v in q["held"].items())
                    + f"; launches a step {q['launches']} (one device "
                    f"{q['one_launches']}); losses {q['losses']} (one device {q['one_losses']}); "
                    f"running mean, var {q['running']}")
                if q["launches"] != q["want_launches"]:
                    raise AssertionError(f"(b) {name} launches {q['launches']}, expected "
                                         f"{q['want_launches']}")
                if q["stats"] > PAIR_STATS_RTOL:
                    raise AssertionError(f"(b) {name} {depth}: running statistics differ")
                if set(q["held"]) != PAIR_HELD[name]:
                    raise AssertionError(f"(b) {name}: CTC calls held {sorted(q['held'])}")
                if not all(st["loss64"] <= SENS_FACTOR * max(st["one_loss64"], PAIR_LOSS_RTOL)
                           and st["tree64"] <= SENS_FACTOR * max(st["one_tree64"],
                                                                 PAIR_LEAF_RTOL)
                           and st["leaf64"] <= SENS_FACTOR * max(st["one_leaf64"],
                                                                 PAIR_LEAF_RTOL)
                           for st in q["steps"]):
                    raise AssertionError(f"(b) the pair on {name}, {depth} depth, is further "
                                         f"from the float64 steps than {SENS_FACTOR} x one "
                                         f"device")
    # (c) TP at full width
    for r, out in enumerate(ranks):
        t = out["tp"]
        log(f"(c) rank {r} {t['mesh']}: the harness's eval architecture (246.7 M parameters, "
            f"{t['n_sharded']} of {t['n_leaves']} leaves split over 'model'), "
            f"make_ctc_train_step with batch_standardize, Adamax, B={ref['B']}, L={ref['L']}, "
            f"3 steps: this rank's params against one device's slices: bit-equal {t['bit']}, "
            f"max_abs_err {t['err']:.3e}, updates ||dp - dp_1|| / ||dp_1|| "
            f"{t['update_err']:.3e} (bound {STEP_PARAM_RTOL}); losses {t['losses']} (one "
            f"device {ref['losses']}); grad norms {t['gnorms']} (one device {ref['gnorms']}); "
            f"launches a step {t['launches']}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(t["losses"], ref["losses"]))
        if not (t["losses"][0] == ref["losses"][0] and loss_rel <= PAIR_LOSS_RTOL
                and t["update_err"] <= STEP_PARAM_RTOL):
            raise AssertionError("(c) the TP steps differ from the single-device steps")
        if t["launches"] != t["want_launches"]:
            raise AssertionError(f"(c) TP launches {t['launches']}, expected "
                                 f"{t['want_launches']}")
    # (d) the decoders, bit for bit against one B6 call
    for r, out in enumerate(ranks):
        d = out["decode"]
        for name, n_out in (("batch", 3), ("seq", 4)):
            got = d[name]["got"]
            if not all(torch.equal(a.cpu(), w.cpu()) for a, w in zip(got, one[:n_out])):
                raise AssertionError(f"(d) rank {r}: the {name}-sharded decode differs from one "
                                     f"B6 call")
            if d[name]["launches"] != DECODE_LAUNCHES:
                raise AssertionError(f"(d) {name} launches {d[name]['launches']}")
    d0 = ranks[0]["decode"]
    log(f"(d) gauss_quality's logits (B={logits.shape[0]}, T={logits.shape[1]}, W={BEAM_WIDTH}): "
        f"distributed_beam_decode on {d0['batch']['mesh']} and seq_sharded_beam_decode on "
        f"{d0['seq']['mesh']}, B6 once a rank each: prefixes, plens, scores (and the seq "
        f"decode's times) equal to one B6 call to the bit on every rank")


# ---- 14. pretraining, fast-WaveNet generation, the autoregressive decoders -----

AR_READS = (100, 201)             # RawSignalGenerator: read lengths uniform in [100, 200]
AR_PAD_TO, AR_LABELS_PAD_TO = 1024, 200   # >= 12 sd above the longest read's mean 650 samples
AR_CONTIGS = 8                    # the stand-in genome: seeded random contigs
AR_CONTIG_BASES = (20_000, 60_000)
PRETRAIN_STEPS = 20
GEN_STEPS = 512
# the generated steps' probabilities against the parallel forward: JAX's
# own test's tolerance (tests/test_fast_wavenet.py), |p_gen - p_par| <=
# rtol p_par + atol; where the argmax of the two differs, the parallel
# forward's top-2 margin lies below twice that bound (the margin rule)
GEN_RTOL, GEN_ATOL = 1e-4, 1e-5
# the decoders on the card against the same weights on the CPU: logits
# within rtol |cpu| + atol max|cpu| while the label sequences agree; where
# they part, the first difference falls on a step whose top-2 margin in
# the CPU's logits is below twice that bound
DEC_RTOL, DEC_ATOL = 1e-4, 1e-5
ENCDEC_MAX_TIME, RNN_MAX_TIME, LABELSYNC_WIDTH = 40, 100, 5


@contextlib.contextmanager
def genome_file(path, seed):
    """A reference genome of AR_CONTIGS seeded random contigs (bases 1..4)
    in RawSignalGenerator's /<contig>/contig layout: written with h5py where
    it imports, else served by ``stand_in_h5py``. Yields which ran."""
    rng = np.random.default_rng(seed)
    contigs = {f"contig_{i}": rng.integers(1, 5, size=int(rng.integers(*AR_CONTIG_BASES)))
               .astype(np.int8) for i in range(AR_CONTIGS)}
    h5py = h5py_or_none()
    if h5py is None:
        with stand_in_h5py(path, {k: {"contig": v} for k, v in contigs.items()}) as how:
            yield how
        return
    with h5py.File(path, "w") as f:
        for k, v in contigs.items():
            f.create_group(k).create_dataset("contig", data=v)
    yield f"h5py {h5py.__version__}: a file written"


def raw_signal_generator(path, seed):
    return RawSignalGenerator(None, str(path), AR_READS, sample_rate=800.0, batch_size=B,
                              pad_to=AR_PAD_TO, labels_pad_to=AR_LABELS_PAD_TO, seed=seed)


def top2_margin_rule(label, ref_logits, ref_labels, got_labels, rtol, atol):
    """Rows whose label sequences differ; each row's first difference must
    fall on a step whose top-2 margin in ref_logits is below twice the
    tolerance rtol |top| + atol max|ref_logits|. Returns {row: step}."""
    ref_logits = ref_logits.float().cpu()
    scale = float(ref_logits.abs().max())
    rows = {}
    for b in torch.nonzero((ref_labels.cpu() != got_labels.cpu()).any(dim=1)).flatten().tolist():
        t = int(torch.nonzero(ref_labels[b].cpu() != got_labels[b].cpu())[0])
        top2 = torch.topk(ref_logits[b, t], 2).values
        bound = 2 * (rtol * float(top2.abs().max()) + atol * scale)
        if not float(top2[0] - top2[1]) < bound:
            raise AssertionError(f"{label}: row {b} parts at step {t} with a top-2 margin "
                                 f"{float(top2[0] - top2[1]):.3e} >= {bound:.3e}")
        rows[b] = t
    return rows


def pretrain_phase(dev, path):
    """(a) pretrain_ctc on build_posenc_encoder(scale=1) and RawSignalGenerator
    batches: the main path's launches (B1, B2 once a step), step 1's B1/B2
    against their plain loops on the step's own inputs, two runs from one
    seed equal to the bit, ctc_loss_flat (B1) equal to ctc_loss; the loss
    curve."""
    encoder = build_posenc_encoder(scale=1, device=dev)
    n_params = sum(p.numel() for p in encoder.parameters())
    first = raw_signal_generator(path, SEED).fetch()
    calls = []   # run 1's B1 calls (args, outputs): step 1's is held below
    runs = []
    for run in range(2):
        gen = raw_signal_generator(path, SEED)
        try:
            with mock.patch.object(ctc_scan, "ctc_fwd", Recorder(ctc_fwd, calls)) \
                    if run == 0 else contextlib.nullcontext():
                reset_counts()
                state, losses = pretrain_ctc(encoder, gen, PRETRAIN_STEPS)
                torch.cuda.synchronize()
                counts = {k: v for k, v in read_counts().items() if v}
        finally:
            gen.close()
        runs.append((state, losses, counts))
    (s1, l1, launches), (s2, l2, counts2) = runs
    want = {"ctc_alpha": PRETRAIN_STEPS, "ctc_beta": PRETRAIN_STEPS,
            **block_launches(encoder, PRETRAIN_STEPS, PRETRAIN_STEPS)}
    if launches != want or counts2 != want:
        raise AssertionError(f"(a) pretrain_ctc launched {launches} / {counts2}, not {want}")
    bit = l1 == l2 and all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    if not bit:
        raise AssertionError(f"(a) two pretrain_ctc runs from one seed differ: losses {l1} "
                             f"vs {l2}, params {rel_err(tree_leaves(s2.params), tree_leaves(s1.params)):.3e}")
    # at Adamax 2e-3 on raw pico-amps the first update overshoots (the loss
    # jumps ~10x at step 2, as the reference's lr does on phase 13's pair);
    # training then brings it down
    if not all(math.isfinite(x) for x in l1) or not sum(l1[-5:]) < sum(l1[1:6]):
        raise AssertionError(f"(a) the loss did not fall after the first update: {l1}")
    # step 1's inputs: the init's forward on the first batch (the recorded
    # step-1 B1 input must be these bits)
    params0 = pretrain._init_params(encoder)
    batch = batch_to_device(first, dev)
    with torch.no_grad():
        logits = torch.func.functional_call(encoder, params0, (batch["signal"],))
    ext, allow = _extend_labels(batch["labels"], 0)
    lp_ext = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
    skip = torch.where(allow, 0.0, NEG)
    if not torch.equal(calls[0][0][0], lp_ext):
        raise AssertionError("(a) step 1's recorded B1 input differs from the init's forward")
    T, Bx, J = lp_ext.shape
    log(f"(a) pretrain_ctc step 1 at B={Bx} T={T} J={J}: geometry (R, C, threads, D) "
        f"{ctc_scan.ctc_geometry(J, 1, Bx, ctc_scan._sms(dev))} (B1)")
    phase_ctc(lp_ext, skip, logits, batch)
    lens = torch.full((Bx,), T, dtype=torch.int32, device=dev)
    reset_counts()
    flat = ctc_loss_flat(logits, lens.cpu().numpy(), first.flat_labels, first.label_lengths)
    flat_counts = {k: v for k, v in read_counts().items() if v}
    dense = ctc_loss(logits, lens, batch["labels"], batch["label_lengths"])
    if flat_counts != {"ctc_alpha": 1} or not torch.equal(flat, dense):
        raise AssertionError(f"(a) ctc_loss_flat {float(flat)} (launches {flat_counts}) != "
                             f"ctc_loss {float(dense)}")
    log(f"(a) PosEnc pretrain_ctc ({encoder.num_features} features, {len(encoder.layers)} "
        f"blocks k=3, out_dim {encoder.out1.w.shape[0]}, positions; "
        f"{n_params} parameters), RawSignalGenerator B={B}, reads {AR_READS[0]}-"
        f"{AR_READS[1] - 1} bases at 800 Hz, pad_to {AR_PAD_TO}, labels_pad_to "
        f"{AR_LABELS_PAD_TO}, Adamax 2e-3, float32: {PRETRAIN_STEPS} steps, "
        f"launches {launches}; two runs from one seed equal to the bit (losses, params); "
        f"ctc_loss_flat equal to ctc_loss (B1 once); loss curve "
        f"{[round(x, 4) for x in l1]}")


def bench_wavenet(dev):
    """bench.py:105-110's WaveNet (256 levels in and out, 30 causal blocks
    d = 1..512 x 3), random weights from SEED, res_w x 1/sqrt(2) as in
    phase 4."""
    net = WaveNet(LEVELS, 2, [(LEVELS, LEVELS, 2, d) for d in WAVENET_DILS], LEVELS,
                  softmax=False, device=dev)
    net.reset_parameters(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for blk in net.stack.blocks:
            blk.res_w.mul_(0.5 ** 0.5)
    return net.eval()


def generation_phase(dev):
    """(b) fast_wavenet.generate on the bench WaveNet: B4 once a block in
    the priming (the main path's launches), held against its plain version
    at the priming's shapes; GEN_STEPS argmax steps whose probabilities
    match one parallel forward over prime + generated levels."""
    net = bench_wavenet(dev)
    prime = torch.from_numpy(onehot_reads(np.random.default_rng(SEED + 14), B, L, LEVELS)).to(dev)
    with torch.no_grad():
        reset_counts()
        levels, probs = fast_wavenet.generate(net, prime, GEN_STEPS)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if v}
        if launches != {"fused_gated_block": len(WAVENET_DILS)}:
            raise AssertionError(f"(b) generate launched {launches}")
        if levels.shape != (B, GEN_STEPS) or not torch.isfinite(probs).all() or \
                not ((levels >= 0) & (levels < LEVELS)).all():
            raise AssertionError("(b) generated levels or probabilities out of shape or range")
        # B4 at the priming's shapes: each block's input on the plain path
        x, err = causal_conv1d(prime, net.entry.w, net.entry.b), 0.0
        for blk in net.stack.blocks:
            a = (blk.gate_w, blk.gate_b, blk.out_w[0], blk.out_b, blk.res_w, blk.res_b)
            got = fused_gated_block(x, *a, blk.dilation)
            want = fused_gated_block_ref(x, *a, blk.dilation)
            err = max(err, hold_b4(blk.dilation, got, want)[0])
            x = want[0]
        # the parallel forward (B4) over prime + generated levels
        full = torch.cat([prime, F.one_hot(levels, LEVELS).float()], dim=1)
        par = torch.softmax(net(full), dim=-1)[:, L - 1:-1]
        diff = (probs - par).abs()
        bad = int((diff > GEN_RTOL * par + GEN_ATOL).sum())
        if bad:
            raise AssertionError(f"(b) {bad} generated probabilities beyond rtol {GEN_RTOL}, "
                                 f"atol {GEN_ATOL} of the parallel forward; max "
                                 f"{float(diff.max()):.3e}")
        parted = top2_margin_rule("(b) generated levels against the parallel argmax", par,
                                  par.argmax(-1), levels, GEN_RTOL, GEN_ATOL / float(par.max()))
    log(f"(b) fast-WaveNet on the bench WaveNet ({LEVELS} levels, {len(WAVENET_DILS)} "
        f"blocks; res_w scaled), B={B} primes of L0={L}: launches {launches}; B4 at the "
        f"priming's {len(WAVENET_DILS)} blocks within "
        f"rtol {B4_RTOL}, atol {B4_ATOL} x max|plain|, max_abs_err {err:.3e}; {GEN_STEPS} "
        f"argmax steps' probabilities within rtol {GEN_RTOL}, atol {GEN_ATOL} of the parallel "
        f"forward over prime + generated (max diff {float(diff.max()):.3e}); levels equal "
        f"to its argmax but {len(parted)} rows parting at near-ties {parted}")


def decoder_on_both(label, decode, decoder, enc):
    """decode(decoder, enc) on the card and on a CPU copy of the decoder
    with the same weights and encodings; the label sequences and lengths
    equal under the margin rule, the logits within DEC_RTOL/DEC_ATOL while
    the labels agree. Returns the card's logits."""
    cpu = copy.deepcopy(decoder).cpu()
    logits, lengths = decode(decoder, enc)
    ref, ref_lengths = decode(cpu, enc.cpu())
    labels, ref_labels = logits.argmax(-1).cpu(), ref.argmax(-1)
    parted = top2_margin_rule(label, ref, ref_labels, labels, DEC_RTOL, DEC_ATOL)
    scale = float(ref.abs().max())
    for b in range(ref.shape[0]):
        t = parted.get(b, ref.shape[1])
        d = (logits[b, :t].cpu() - ref[b, :t]).abs()
        if (d > DEC_RTOL * ref[b, :t].abs() + DEC_ATOL * scale).any():
            raise AssertionError(f"{label}: row {b}'s logits beyond tolerance, max {float(d.max()):.3e}")
        if b not in parted and int(lengths[b]) != int(ref_lengths[b]):
            raise AssertionError(f"{label}: row {b}'s length {int(lengths[b])} != the CPU's "
                                 f"{int(ref_lengths[b])}")
    log(f"{label}: logits {tuple(logits.shape)}, lengths {lengths.tolist()}; equal to the CPU's "
        f"(labels, lengths, logits within rtol {DEC_RTOL}, atol {DEC_ATOL} x max|logit|) but "
        f"{len(parted)} rows parting at near-ties {parted}")
    return logits


def labelsync_on_both(label, logits):
    """BeamSearchDecoder(beam_width=LABELSYNC_WIDTH) on the card and on the
    CPU on the same logits: hypotheses equal, scores within 1e-5."""
    B_, _, C = logits.shape
    card = BeamSearchDecoder(B_, C, beam_width=LABELSYNC_WIDTH, device=logits.device)
    cpu = BeamSearchDecoder(B_, C, beam_width=LABELSYNC_WIDTH, device="cpu")
    probas, hyps = card.decode(logits, channels_last=True)
    cprobas, chyps = cpu.decode(logits.cpu(), channels_last=True)
    if hyps != chyps or max(abs(a - b) for a, b in zip(probas, cprobas)) > 1e-5 * max(
            1.0, max(map(abs, cprobas))):
        raise AssertionError(f"{label}: the card's label-sync beam differs from the CPU's")
    log(f"{label} BeamSearchDecoder(beam_width={LABELSYNC_WIDTH}): hypotheses equal to the "
        f"CPU's on equal logits (lengths {[len(h) for h in hyps]})")


def decoders_phase(dev, path):
    """(c) EncDec (a 512 x 25 encoder + ByteNetDecoder, 32 channels,
    max_time ENCDEC_MAX_TIME) and the RNN pair (512 x 25 + RNNByteNetDecoder,
    hidden 256, 3 layers, max_time RNN_MAX_TIME) at scale 1, random weights,
    on the encodings of one RawSignalGenerator batch: generate and unfold,
    then the label-sync beam on their logits, against the CPU."""
    gen = raw_signal_generator(path, SEED + 2)
    try:
        signal = torch.from_numpy(gen.fetch().signal).to(dev)
    finally:
        gen.close()
    for name, build, decode in (
            ("EncDec generate", lambda: build_encdec(scale=1, max_time=ENCDEC_MAX_TIME,
                                                     device=dev),
             lambda d, e: d.generate(e)),
            ("RNN pair unfold", lambda: build_rnn_decoder_pair(scale=1, max_time=RNN_MAX_TIME,
                                                              device=dev),
             lambda d, e: d.unfold(e))):
        encoder, decoder = build()
        encoder.reset_parameters(torch.Generator().manual_seed(SEED))
        decoder.reset_parameters(torch.Generator().manual_seed(SEED + 1))
        with torch.no_grad():
            enc = encoder.eval()(signal)
        del encoder
        logits = decoder_on_both(f"(c) {name}", decode, decoder.eval(), enc)
        labelsync_on_both(f"(c) {name}", logits)


def run_autoregressive(dev):
    """Phase 14: the pretraining loop, fast-WaveNet generation and the
    autoregressive decoders with the label-sync beam."""
    dev = resolve_device(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ar_") as tmp:
        path = Path(tmp) / "genome.hdf5"
        with genome_file(path, SEED) as how:
            log(f"phase 14 genome: {AR_CONTIGS} seeded random contigs of "
                f"{AR_CONTIG_BASES[0]}-{AR_CONTIG_BASES[1]} bases ({how})")
            pretrain_phase(dev, path)
            torch.cuda.empty_cache()
            generation_phase(dev)
            torch.cuda.empty_cache()
            decoders_phase(dev, path)
    check_numerics("phase 14")


# ---- 15. the last slice: NPZ shards, the hyperparameter search, the kmer experiments --

NPZ_SHARDS, NPZ_READS = 4, 16              # (a): shards of reads, all of L samples
NPZ_BASES = (400, 430)                     # label reads of 400-429 bases: S <= 429
NPZ_WORKERS, NPZ_STEPS = 2, 5              # 5 steps after a warm one, then 1 traced
NPZ_TIMEOUT = 120.0                        # a spawned worker's start, generously
NPZ_STEP_LAUNCHES = {"fused_gated_block": len(WAVENET_DILS) + len(CLASSIFIER_DILS) + 1,
                     "fused_gated_block_bwd": len(WAVENET_DILS) + len(CLASSIFIER_DILS) + 1,
                     "fused_gated_block_centred": len(CLASSIFIER_DILS) + 1, "ctc_alpha": 1,
                     "ctc_beta": 1}
# the CUDA kernels of B4, B5, B1, B2 in the float32 step (csrc/*.cu)
TRACE_KERNELS = {"B4": ("fused_gated_block_kernel",),
                 "B5": ("bwd_rows_kernel", "bwd_wgrad_kernel"),
                 "B1": ("ctc_alpha_kernel",), "B2": ("ctc_beta_kernel",)}
SEARCH_SPACE = {"training.optim.learning_rate": (1e-5, 1e-2, "log"),
                "training.optim.max_grad_norm": (0.5, 50.0, "log")}
SEARCH_TRIALS = 4
# (b): each trial cut to 10 steps, validation (1 fixed batch) at steps 5 and 10
SEARCH_CUTS = {"max_iters": 10, "print_every": 5, "save_every": 1000,
               "fixed_valid_batches": 1}
SEARCH_LAUNCHES = {"ctc_alpha": SEARCH_CUTS["max_iters"] + 2,
                   "ctc_beta": SEARCH_CUTS["max_iters"]}
# (c): the experiments at main()'s defaults but mapping's steps, cut from
# 2000 to 500 for the script's time; the card's first loss against the
# CPU's from the same init and batch
KMER_RUNS = {
    "mapping": ("run_mapping", 500, dict(batch_size=32, nhid=512, lr=2e-3)),
    "stay": ("run_stay", 300, dict(batch_size=32, num_features=128, lr=1e-3)),
    "decode": ("run_decode", 300, dict(batch_size=32, nt_length=100, channels=128,
                                       enc_dim=256, lr=2e-3)),
}
KMER_FIRST_RTOL = 1e-4
DECODE_CE_BOUND = 1.2                      # JAX's tests/test_kmer_experiments.py:41


def write_npz_shards(tmp):
    """NPZ_SHARDS shards of NPZ_READS seeded reads: levels 0-255 of exactly
    L samples (a 2-D array), label reads of 400-429 bases in 1..4."""
    rng = np.random.default_rng(SEED)
    for s in range(NPZ_SHARDS):
        signals = rng.integers(0, LEVELS, size=(NPZ_READS, L)).astype(np.uint8)
        reads = np.array([rng.integers(1, LABELS, size=int(rng.integers(*NPZ_BASES)))
                          for _ in range(NPZ_READS)], dtype=object)
        np.savez(Path(tmp) / f"shard_{s}.npz", signals=signals, reads=reads)
    return str(Path(tmp) / "shard_*.npz")


def drain(loader):
    """Every batch of a fresh loader, then close() it."""
    try:
        return [loader.dequeue(timeout=NPZ_TIMEOUT) for _ in range(loader.max_iters)]
    finally:
        loader.close()


def check_closed(loader, label):
    alive = [p.pid for p in loader._procs if p.is_alive()]
    if alive:
        raise AssertionError(f"(a) {label}: workers {alive} alive after close()")


def trace_kernels(path):
    """The CUDA kernels' names in a Chrome trace."""
    return {e["name"] for e in json.loads(Path(path).read_text())["traceEvents"]
            if e.get("cat") == "kernel"}


def npz_joint_step(dev):
    """(a) NPZ shards through NPZQueueLoader into the bench joint step.
    Three loaders start together, since a spawned worker's start is the
    slow part: two single-worker streams from one seed, and the main
    path's, whose queue fills meanwhile."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_npz_") as tmp:
        pattern = write_npz_shards(tmp)
        one, twin = (NPZQueueLoader(pattern, batch_size=B, num_levels=LEVELS, num_workers=1,
                                    max_iters=2, seed=SEED) for _ in range(2))
        loader = NPZQueueLoader(pattern, batch_size=B, num_levels=LEVELS, one_hot=True,
                                num_workers=NPZ_WORKERS, max_iters=NPZ_STEPS + 2, seed=SEED)
        try:
            npz_streams(one, twin)
            npz_steps(dev, loader, Path(tmp) / "trace")
        finally:
            for ld in (one, twin, loader):
                ld.close()
        for ld, label in ((one, "single worker"), (twin, "twin"),
                          (loader, f"{NPZ_WORKERS} workers")):
            check_closed(ld, label)


def npz_streams(one, twin):
    """The single worker's first batch equal to its recomputation here from
    the worker's seed, and the two single-worker streams equal."""
    first = one.dequeue(timeout=NPZ_TIMEOUT)
    stream = [first, one.dequeue(timeout=NPZ_TIMEOUT)]
    again = npz_loader.make_batch(one.paths, np.random.default_rng(one.worker_seeds[0]),
                                  B, LEVELS, True)
    for f, a in zip(FIELDS, again):
        if not np.array_equal(getattr(first, f), a) or getattr(first, f).dtype != a.dtype:
            raise AssertionError(f"(a) the worker's first batch differs from its "
                                 f"recomputation in {f}")
    for i, (a, b) in enumerate(zip(stream, drain(twin))):
        if not all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS):
            raise AssertionError(f"(a) two single-worker streams from one seed differ "
                                 f"at batch {i}")
    if first.signal.shape != (B, L, LEVELS) or not first.labels.shape[1] <= S_LABELS:
        raise AssertionError(f"(a) batch shapes {first.signal.shape}, {first.labels.shape}")
    log("(a) NPZQueueLoader: the first batch equals its recomputation from the worker's "
        "seed, two single-worker streams equal")


def npz_steps(dev, loader, trace_dir):
    """The main path: a warm step and NPZ_STEPS steps of the bench model fed
    by the loader, then one step under profiling.trace."""
    model = scale_res_w(Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED))
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"))
    state = TrainState.create(param_tree(model.model_base, model.model_ctc), tx)
    losses, labels_s = [], []
    for i in range(NPZ_STEPS + 1):
        batch = loader.dequeue(timeout=NPZ_TIMEOUT)
        labels_s.append(batch.labels.shape[1])
        reset_counts()
        state, m = step(state, batch_to_device(batch, dev))
        losses.append(float(m["total_loss"]))
        counts = {k: v for k, v in read_counts().items() if v}
        if counts != NPZ_STEP_LAUNCHES:
            raise AssertionError(f"(a) step {i}: launches {counts}, expected "
                                 f"{NPZ_STEP_LAUNCHES}")
    batch = loader.dequeue(timeout=NPZ_TIMEOUT)
    with profiling.trace(str(trace_dir)) as prof:
        state, m = step(state, batch_to_device(batch, dev))
        losses.append(float(m["total_loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(a) losses {losses}")
    kernels = trace_kernels(prof.trace_path)
    missing = [k for k, names in TRACE_KERNELS.items()
               if not any(n in name for n in names for name in kernels)]
    if missing:
        raise AssertionError(f"(a) the trace names no CUDA kernel of {missing}: "
                             f"{sorted(kernels)[:20]}")
    log(f"(a) NPZ-fed joint step (bench model, f32, Adagrad {TRAIN_LR}, B={B}, L={L}, S "
        f"{min(labels_s)}-{max(labels_s)}, {NPZ_WORKERS} workers): launches a step "
        f"{NPZ_STEP_LAUNCHES} (phase 5 holds these kernels at this shape); losses "
        f"{[round(x, 4) for x in losses]}; the trace {Path(prof.trace_path).name} names "
        f"{len(kernels)} CUDA kernels, B4's, B5's, B1's and B2's among them")


def search_cfg(values, run_dir):
    cfg = json.loads(LONG_CONFIG.read_text())
    cfg["training"].update(SEARCH_CUTS)
    for path, v in values.items():
        cfg = set_config_path(cfg, path, v)
    return set_config_path(cfg, "training.save_dir", str(run_dir))


def hyperparameter_search(dev):
    """(b) BayesOpt over cli_objective on configs/gauss_quality.json."""
    base = json.loads(LONG_CONFIG.read_text())
    base["training"].update(SEARCH_CUTS)
    objective = cli_objective(base, device=dev)
    want = {**SEARCH_LAUNCHES, **cfg_block_launches(base, SEARCH_CUTS["max_iters"] + 2,
                                                      SEARCH_CUTS["max_iters"])}
    counts = []

    def counted(values):
        reset_counts()
        y = objective(values)
        torch.cuda.synchronize()
        counts.append({k: v for k, v in read_counts().items() if v})
        return y

    best = BayesOpt(SEARCH_SPACE, seed=SEED).minimize(counted, num_trials=SEARCH_TRIALS)
    for i, ((values, y), c) in enumerate(zip(best["trials"], counts)):
        log(f"(b) trial {i}: lr {values['training.optim.learning_rate']:.4e}, max_grad_norm "
            f"{values['training.optim.max_grad_norm']:.4f} -> vloss {y!r}; launches {c}")
        if not math.isfinite(y):
            raise AssertionError(f"(b) trial {i}: vloss {y}")
        if c != want:
            raise AssertionError(f"(b) trial {i}: launches {c}, expected {want}")
    cpu = BayesOpt(SEARCH_SPACE, seed=SEED)
    for i, (values, y) in enumerate(best["trials"]):
        if cpu.suggest() != values:
            raise AssertionError(f"(b) trial {i}: the card's search suggested {values}, a "
                                 f"CPU search fed the same values another point")
        cpu.observe(values, y)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_search_") as tmp:
        again = cli.train_with_result(search_cfg(best["values"], tmp), dev)["vloss"]
    if again != best["value"]:
        raise AssertionError(f"(b) the best trial re-run: vloss {again!r} != {best['value']!r}")
    log(f"(b) BayesOpt({list(SEARCH_SPACE)}, seed={SEED}) over cli_objective on "
        f"configs/gauss_quality.json at full width (cut: {SEARCH_CUTS}): {SEARCH_TRIALS} "
        f"trials, best vloss {best['value']!r}, equal to the "
        f"bit when its config is re-run; suggestions equal to a CPU search's; "
        f"launches a trial {want} (10 steps, 2 validations; phase 10 holds B1/B2 "
        f"at J=179)")


def kmer_runs(dev):
    """(c) the kmer experiments on the card at main()'s default widths."""
    for name, (run, steps, kw) in KMER_RUNS.items():
        fn = getattr(kmer_experiments, run)
        want = fn(1, seed=SEED, device="cpu", **kw)
        seen = []
        last = fn(steps, seed=SEED, device=dev, callback=lambda k, loss: seen.append(loss), **kw)
        losses = torch.stack(seen).cpu()
        first = float(losses[0])
        if not torch.isfinite(losses).all():
            raise AssertionError(f"(c) {name}: a loss is not finite")
        if not math.isclose(first, want, rel_tol=KMER_FIRST_RTOL):
            raise AssertionError(f"(c) {name}: the first loss {first!r} on the card, "
                                 f"{want!r} on the CPU")
        if name == "decode" and not last < DECODE_CE_BOUND:
            raise AssertionError(f"(c) decode: final CE {last} >= {DECODE_CE_BOUND}")
        extra = (f", chance ln 1024 = {math.log(1024):.4f}" if name == "mapping" else
                 f", bound {DECODE_CE_BOUND}" if name == "decode" else "")
        log(f"(c) {name} ({kw}, {steps} steps): first loss {first!r} (CPU {want!r}), final "
            f"{last!r}{extra}")


def run_last_slice(dev):
    """Phase 15: the NPZ shard loader into the bench joint step, the
    hyperparameter search over train, the kmer experiments."""
    dev = resolve_device(dev)
    npz_joint_step(dev)
    torch.cuda.empty_cache()
    hyperparameter_search(dev)
    torch.cuda.empty_cache()
    kmer_runs(dev)
    check_numerics("phase 15")


# ---- 16. the multi-tensor guard and optimizer ------------------------------------

MT_LEAVES = {"wavenet_ctc": 402, "raw_ctcnet": 816}   # the benchmark's two train trees
MT_STEP_LAUNCHES = 10   # guard: absmax 2, sum of squares 2, select 1; update: rule 1,
#                         learning rate 1, select updates 1, select state 1, add 1
# ulps a stage's outputs may sit from its plain version's: the rules and
# selects repeat PyTorch's per-leaf arithmetic operation by operation;
# the reductions sum in another order (relative, over each leaf's value)
MT_ULPS = 0
MT_REDUCE_RTOL = 1e-5


def ulp_gap(a, b):
    """Largest distance in float32 steps between a and b (NaN where exactly
    one of them is NaN)."""
    if torch.isnan(a).ne(torch.isnan(b)).any():
        return math.nan
    ia, ib = (torch.where(torch.isnan(t), 0.0, t).view(torch.int32).to(torch.int64)
              for t in (a, b))
    ia, ib = (torch.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int((ia - ib).abs().max()) if a.numel() else 0


def plain_multi_tensor():
    """Every ops.multi_tensor call takes its plain version (per-leaf
    operators) on CUDA leaves too."""
    return mock.patch.object(multi_tensor, "_on_card", lambda xs: False)


def mt_trees(dev):
    """The two train cells' parameter trees on the card: the bench WaveNet-CTC
    (phase 5's model) and the harness's 246.7 M-parameter RawCTCNet."""
    wn = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    shapes = {k: v.shape for k, v in
              gaussian_eval.build_model(1.0, nhid=512, device="meta").state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    raw = {k: 0.05 * torch.randn(sh, generator=g, device=dev) for k, sh in shapes.items()}
    trees = {"wavenet_ctc": (param_tree(wn.model_base, wn.model_ctc), "adagrad", TRAIN_LR),
             "raw_ctcnet": (raw, "adamax", 2e-4)}
    for name, (tree, _, _) in trees.items():
        if len(tree_leaves(tree)) != MT_LEAVES[name]:
            raise AssertionError(f"{name}: {len(tree_leaves(tree))} leaves, expected "
                                 f"{MT_LEAVES[name]}")
    return wn, trees


def mt_grads(tree, seed, scale=1e-3):
    g = torch.Generator(device=tree_leaves(tree)[0].device).manual_seed(seed)
    return tree_map(lambda p: scale * torch.randn(p.shape, generator=g, device=p.device), tree)


def mt_stage_checks(name, leaves, grads):
    """Each stage on the kernels against its plain version on the card."""
    g = [x.contiguous() for x in grads]
    p = leaves
    s = [x.abs() + 0.1 for x in mt_grads(p, 5, 1.0)]
    m = mt_grads(p, 6)
    c1 = 1 - torch.pow(0.9, torch.tensor(7.0, device=p[0].device))
    c2 = 1 - torch.pow(0.999, torch.tensor(7.0, device=p[0].device))
    ok, lr = torch.tensor(True, device=p[0].device), torch.tensor(-2e-4, device=p[0].device)
    absmax = multi_tensor.absmax_ref(g)
    scale = torch.clamp(absmax.max(), min=torch.finfo(torch.float32).tiny)
    stages = {
        "absmax": (lambda f: [f.absmax(g)]),
        "sum_squares": (lambda f: [f.sum_squares(g, scale)]),
        "select": (lambda f: f.select(ok, g) + f.select(~ok, g, p)),
        "scale": (lambda f: f.scale(g, -2e-4) + f.scale(g, lr)),
        "add_scaled": (lambda f: f.add_scaled(g, p, 1e-2)),
        "add": (lambda f: f.add(p, g)),
        "rss": (lambda f: sum(f.rss(g, s, 1e-7), [])),
        "rms": (lambda f: sum(f.rms(g, s, 0.9, 1e-8), [])),
        "adam": (lambda f: sum(f.adam(g, m, s, 0.9, 0.999, 1e-8, c1, c2), [])),
        "adamax": (lambda f: sum(f.adamax(g, m, s, 0.9, 0.999, 1e-8, c1), [])),
    }
    out = {}
    for stage, fn in stages.items():
        got = fn(multi_tensor)
        with plain_multi_tensor():
            want = fn(multi_tensor)
        torch.cuda.synchronize()
        if stage == "sum_squares":
            gap = float(((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-30)).max())
            bad = not gap <= MT_REDUCE_RTOL
        else:
            gap = max(ulp_gap(a, b) for a, b in zip(got, want))
            bad = not gap <= MT_ULPS
        out[stage] = gap
        if bad:
            raise AssertionError(f"phase 16 {name}: {stage} on the kernels is {gap} from its "
                                 f"plain version")
    log(f"phase 16 {name}: each stage against its plain version on the card (ulps; "
        f"sum_squares relative, bound {MT_REDUCE_RTOL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in out.items()))


def mt_guard_checks(name, grads):
    """The guard on injected leaves: a NaN, an inf, finite |g| ~1e19 (whose
    squares overflow float32), an all-zero tree; against the plain guard."""
    out = {}
    for case in ("finite", "nan", "inf", "1e19", "zeros"):
        g = tree_map(torch.clone, grads)
        leaves = tree_leaves(g)
        if case in ("nan", "inf"):
            leaves[len(leaves) // 2].view(-1)[3] = math.nan if case == "nan" else math.inf
        elif case == "1e19":
            leaves[-1].mul_(3e22)
        elif case == "zeros":
            for x in leaves:
                x.zero_()
        got = (float(global_norm_safe(g)), bool(all_finite(g)))
        with plain_multi_tensor():
            want = (float(global_norm_safe(g)), bool(all_finite(g)))
        finite = case not in ("nan", "inf")
        same_norm = (math.isnan(got[0]) and math.isnan(want[0])) or \
            abs(got[0] - want[0]) <= MT_REDUCE_RTOL * abs(want[0])
        if got[1] != want[1] or got[1] != finite or not same_norm:
            raise AssertionError(f"phase 16 {name}: guard on {case}: kernels (norm, finite) "
                                 f"{got}, plain {want}")
        out[case] = got
    log(f"phase 16 {name}: guard (norm, all finite) on the kernels, as the plain guard's: "
        + ", ".join(f"{k} ({v[0]:.6g}, {v[1]})" for k, v in out.items()))


def mt_update(tree, grads, optim_type, lr, total):
    """One guarded update (the train step's guard and optimizer) of a fresh
    state of tree, on the given gradients."""
    tx = build_optimizer(optim_type, lr)
    state = TrainState.create(tree, tx)
    return lambda: trainer._guarded_update(state, total, grads, tx)


def mt_checkpoints_equal(name, one, plain, dev):
    """A checkpoint of the kernels' state (each output list one allocation
    cut into views) has the bytes of one of the plain update's (a storage a
    leaf), whose leaves are equal to the bit."""
    step = torch.ones((), dtype=torch.int32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for tag, out in (("kernels", one), ("plain", plain)):
            save_checkpoint(os.path.join(tmp, tag), TrainState(out[0], out[1], step))
            files.append((Path(tmp) / tag / "1" / "state.pt").read_bytes())
    if files[0] != files[1]:
        raise AssertionError(f"phase 16 {name}: the kernels' checkpoint differs from the "
                             f"plain update's")
    log(f"phase 16 {name}: checkpoints of the kernels' and the plain update's states: the "
        f"same {len(files[0])} bytes")


def mt_tree_phase(name, tree, optim_type, lr, dev, checkpoint):
    leaves = tree_leaves(tree)
    grads = mt_grads(tree, 1)
    mt_stage_checks(name, leaves, tree_leaves(grads))
    mt_guard_checks(name, grads)
    total = torch.tensor(1.5, device=dev)
    run = mt_update(tree, grads, optim_type, lr, total)
    before = multi_tensor.launches
    one = run()
    torch.cuda.synchronize()
    launches = multi_tensor.launches - before
    two = run()
    with plain_multi_tensor():
        plain = run()
    torch.cuda.synchronize()
    flat = lambda out: tree_leaves((out[0], out[1])) + [out[2]]
    if not all(torch.equal(a, b) for a, b in zip(flat(one), flat(two))):
        raise AssertionError(f"phase 16 {name}: two guarded updates differ")
    gaps = [ulp_gap(a.float(), b.float()) for a, b in zip(flat(one)[:-1], flat(plain)[:-1])]
    norm_gap = abs(float(one[2]) - float(plain[2])) / float(plain[2])
    if launches != MT_STEP_LAUNCHES or max(gaps) > MT_ULPS or norm_gap > MT_REDUCE_RTOL:
        raise AssertionError(f"phase 16 {name}: launches {launches} (expected "
                             f"{MT_STEP_LAUNCHES}), params and state {max(gaps)} ulps from "
                             f"the plain update's, norm {norm_gap:.3e}")
    if checkpoint:
        mt_checkpoints_equal(name, one, plain, dev)
    try:
        multi_tensor.select(torch.tensor(True, device=dev), [leaves[0].half()])
        raise AssertionError(f"phase 16 {name}: a float16 CUDA leaf did not raise")
    except ValueError:
        pass
    log(f"phase 16 {name}: {len(leaves)} leaves, {sum(l.numel() for l in leaves)} elements, "
        f"{optim_type}: a guarded update {launches} launches; two runs bit-equal; params "
        f"and state {max(gaps)} ulps from the plain update's, norm {norm_gap:.3e}; float16 "
        f"raises")


def mt_step_launches(model, dev):
    """The main path: one full-width joint train step (Adagrad) on the
    card goes through the kernels, MT_STEP_LAUNCHES launches."""
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"))
    state = TrainState.create(param_tree(model.model_base, model.model_ctc), tx)
    before = multi_tensor.launches
    state, m = step(state, bench_batch(dev))
    torch.cuda.synchronize()
    launches = multi_tensor.launches - before
    if launches != MT_STEP_LAUNCHES or int(m["skipped_nonfinite"]) != 0:
        raise AssertionError(f"phase 16: a train step launched {launches} multi-tensor "
                             f"kernels (expected {MT_STEP_LAUNCHES}), skipped "
                             f"{int(m['skipped_nonfinite'])}")
    log(f"phase 16: a full-width joint train step: {launches} multi-tensor launches")


def run_multi_tensor(dev):
    """Phase 16: csrc/multi_tensor.cu at the two train cells' trees."""
    dev = resolve_device(dev)
    model, trees = mt_trees(dev)
    mt_step_launches(model, dev)
    del model
    for name, (tree, optim_type, lr) in trees.items():
        # the RawCTCNet's pair of checkpoints would be 2 x 3 GB: the WaveNet's shows it
        mt_tree_phase(name, tree, optim_type, lr, dev, name == "wavenet_ctc")
        torch.cuda.empty_cache()
    check_numerics("phase 16")


# ---- phase 17: Bonito's transformer basecaller (configs/bonito_sup_v5.json)
TX_CONFIG = Path(__file__).resolve().parent / "configs" / "bonito_sup_v5.json"
TX_B, TX_T, TX_H, TX_DH, TX_WINDOW = 32, 1024, 8, 64, (127, 128)  # the train cell's layer
TX_RTOL, TX_ATOL = 1e-4, 1e-5  # split products vs einsum: sums in another order (x max |ref|)
TX_CTC = (8, 2048, 1030)       # (b): B, logit frames, labels: J = 2061
TX_STEPS, TX_STEP_B = 3, 32    # (c): train steps at full width on 12,288-sample chunks
TX_CLI_STEPS = 4               # (d): the train entry point


def tx_band_inputs(B, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, TX_T, 3, TX_H, TX_DH), generator=g).cuda()
    do = torch.randn((B, TX_T, TX_H, TX_DH), generator=g).cuda()
    return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2], do


def tx_run(q, k, v, do):
    """The kernels' (o, lse, dq, dk, dv)."""
    o, lse = wa.window_attention_fwd(q, k, v, TX_WINDOW)
    return (o, lse, *wa.window_attention_bwd(q, k, v, o, lse, do, TX_WINDOW))


def tx_plain(q, k, v, do):
    """The plain version's (o, lse, dq, dk, dv), through autograd."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = wa.window_attention_ref(*leaves, TX_WINDOW)
    return (o.detach(), lse.detach(), *torch.autograd.grad(o, leaves, do))


def tx_kernels(dev):
    """(a) the band kernels at the train cell's B = 32 held to their plain
    version, two runs bit-equal."""
    q, k, v, do = tx_band_inputs(TX_B, SEED)
    got, want = tx_run(q, k, v, do), tx_plain(q, k, v, do)
    names = ("o", "lse", "dq", "dk", "dv")
    errs = {n: float((a - b).abs().max() / b.abs().max()) for n, a, b in zip(names, got, want)}
    for n, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=TX_RTOL, atol=TX_ATOL * float(b.abs().max()),
                                   msg=f"window attention {n}")
    if not all(torch.equal(a, b) for a, b in zip(got, tx_run(q, k, v, do))):
        raise AssertionError("window attention: two runs differ")
    log(f"phase 17 (a): band kernels at B={TX_B}, T={TX_T}, H={TX_H}, dh={TX_DH}, "
        f"window {TX_WINDOW}: max err / max |plain| {errs}; two runs bit-equal")


def tx_ctc(dev):
    """(b) B1/B2 at the cell's J = 2061 over T = 2048 frames against their
    plain versions."""
    B, T, S = TX_CTC
    gen = np.random.default_rng(SEED)
    logits = torch.from_numpy(gen.normal(size=(B, T, 5)).astype(np.float32))
    labels = torch.from_numpy(gen.integers(1, 5, size=(B, S)).astype(np.int32))
    lab = torch.from_numpy(gen.integers(S - 80, S + 1, size=(B,)).astype(np.int32))
    ext, allow = _extend_labels(labels, 0)
    lp = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous().to(dev)
    skip = torch.where(allow, 0.0, NEG).to(dev)
    lens, lab = torch.full((B,), T, dtype=torch.int32, device=dev), lab.to(dev)
    cot = torch.ones((B,), device=dev)
    got = ctc_fwd(lp, skip, lens, lab)
    want = ctc_fwd_ref(lp, skip, lens, lab)
    gg = ctc_bwd(lp, want[1], skip, lens, lab, want[0], cot)
    gw = ctc_bwd_ref(lp, want[1], skip, lens, lab, want[0], cot)
    torch.cuda.synchronize()
    check_close("B1 at J=2061", got[0], want[0], 1e-5, 1e-5)
    check_close("B2 at J=2061", gg[0], gw[0], 1e-4, 1e-6)
    log(f"phase 17 (b): B1 / B2 at B={B}, T={T}, J={2 * S + 1} (geometry "
        f"{ctc_scan.ctc_geometry(2 * S + 1, 1, B, torch.cuda.get_device_properties(dev).multi_processor_count)}): "
        f"held to the plain versions")


def tx_chunks(B, seed):
    """B raw Gaussian reads of 950-1030 bases at 12 samples a base, in
    12,288-sample chunks (the train cell's traffic, at its mean rate)."""
    gen = np.random.default_rng(seed)
    table = np.load(DEFAULT_KMER_MODEL)
    sig = np.zeros((B, 12288, 1), np.float32)
    labels = np.zeros((B, 1030), np.int32)
    lab_lens = gen.integers(950, 1031, size=B).astype(np.int32)
    for b, n in enumerate(lab_lens):
        seq = gen.integers(1, 5, size=int(n)).astype(np.int32)
        ks = np.repeat(kmer_ids(seq, 2), 12)
        sig[b, :len(ks), 0] = gen.normal(table["means"][ks], table["stdvs"][ks])
        labels[b, :n] = seq
    return {"signal": sig, "labels": labels, "label_lengths": lab_lens}


def tx_model(dev):
    """(c) Model("transformer-ctc") at Bonito sup v5's widths: the CTC
    step (batch_standardize, AdamW on the multi-tensor kernels) for
    TX_STEPS steps at B = TX_STEP_B chunks, and short reads through
    Basecaller.__call__."""
    cfg = json.loads(TX_CONFIG.read_text())
    model = Model("transformer-ctc", cfg, device=dev).init(SEED)
    net = model.model_ctc
    n = sum(p.numel() for p in net.parameters())
    if n != 76_623_557:
        raise AssertionError(f"transformer parameters {n} != 76,623,557")
    tx = build_optimizer("adamw", 2e-3, weight_decay=0.01)
    step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
    state = TrainState.create({k: v.detach().clone() for k, v in net.state_dict().items()}, tx)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tx_chunks(TX_STEP_B, SEED).items()}
    losses = []
    wa.launches = 0
    for _ in range(TX_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["total_loss"]))
    launches = wa.launches
    if launches != 3 * net.depth * TX_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"transformer steps: band launches {launches}, losses {losses}")
    log(f"phase 17 (c): Model('transformer-ctc') {n:,} parameters; {TX_STEPS} CTC steps at "
        f"B={TX_STEP_B} x 12288 samples: losses {losses}, band launches {launches} (3 a layer "
        f"a step)")
    model.model_ctc.load_state_dict(state.params)
    reads = tx_chunks(4, SEED + 1)["signal"][:, :6000]
    caller = Basecaller(model, beam_width=BEAM_WIDTH, logit_length_fn=model.output_length,
                        device=dev)
    before = wa.launches
    seqs, scores = caller(reads)
    if wa.launches - before != net.depth or len(seqs) != 4 or not all(map(math.isfinite, scores)):
        raise AssertionError(f"transformer basecall: {wa.launches - before} band launches, "
                             f"{len(seqs)} reads, scores {scores}")
    log(f"phase 17 (c): Basecaller.__call__ on 4 reads of 6000 samples: lengths "
        f"{[len(s) for s in seqs]}, scores {[round(s, 2) for s in scores]}")
    try:   # a read longer than a chunk: the grid would count samples
        caller.basecall_long(reads[0], chunk_len=4096)
    except ValueError as e:
        log(f"phase 17 (c): basecall_long refuses the transformer: {str(e)[:100]}...")
    else:
        raise AssertionError("basecall_long took the transformer")


def tx_cli(dev):
    """(d) the train entry point on configs/bonito_sup_v5.json, TX_CLI_STEPS
    steps at B=4."""
    cfg = json.loads(TX_CONFIG.read_text())
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_tx_"))
    cfg["training"].update(batch_size=4, save_dir=str(run_dir), max_iters=TX_CLI_STEPS,
                           print_every=2, save_every=TX_CLI_STEPS)
    try:
        before = wa.launches
        result = cli.train_with_result(cfg, dev)
        torch.cuda.synchronize()
        if result["steps"] != TX_CLI_STEPS or not math.isfinite(result["train_loss"]):
            raise AssertionError(f"transformer train entry point: {result}")
        log(f"phase 17 (d): train on configs/bonito_sup_v5.json, {TX_CLI_STEPS} steps at B=4: "
            f"{result}; band launches {wa.launches - before}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def run_transformer(dev):
    """Phase 17: Bonito's transformer basecaller on the card."""
    dev = resolve_device(dev)
    tx_kernels(dev)
    tx_ctc(dev)
    torch.cuda.empty_cache()
    tx_model(dev)
    torch.cuda.empty_cache()
    tx_cli(dev)
    check_numerics("phase 17")


# ---- 18. centred blocks on B4/B5 ---------------------------------------------------

# train.raw_ctcnet (h100_bench/configs/raw_ctcnet_eval.json): B=24 reads of 567
# samples, 569 frames after the featurizer; its blocks (C_in, C, K, d): one of
# 512 at K=2 d=1, the widest-dilated one at K=3 d=16, and the 2048-wide input
# block; the model: 100 blocks of 512 (K 2, 3 over d 1...16, 10 cycles)
RAW_B, RAW_L, RAW_LABELS, RAW_FEATURES = 24, 569, 89, 2048
CENTRED_BLOCKS = ((512, 512, 2, 1), (512, 512, 3, 16), (2048, 512, 2, 1))
RAW_LAYERS = [(512, 512, k, d) for k in (2, 3) for d in [1, 2, 4, 8, 16] * 10]


def centred_operands(dev, seed, C_in, C, K):
    """A block's operands at the models' init scale (kernels of variance
    1/fan_in) and cotangents, B=RAW_B, L=RAW_L."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(dev)
    k = lambda fan_in: 3.0 ** 0.5 / fan_in ** 0.5
    x = u(RAW_B, RAW_L, C_in)
    fw = (u(K, C_in, 2 * C) * k(K * C_in), u(2 * C) * 0.1, u(C, 2 * C) * k(C),
          u(2 * C) * 0.1, u(C_in, C) * k(C_in), u(C) * 0.1)
    return x, fw, u(RAW_B, RAW_L, C), u(RAW_B, RAW_L, C)


def phase_centred_blocks(dev):
    """B4 and B5 with the centred tap origin at train.raw_ctcnet's block
    shapes against the kernels' arithmetic (hold_f32_block; two B5 calls
    bit-equal)."""
    for i, (C_in, C, K, d) in enumerate(CENTRED_BLOCKS):
        x, fw, dr, ds = centred_operands(dev, SEED + 18 + i, C_in, C, K)
        gw, gb, ow, _, rw, _ = fw
        with torch.inference_mode():
            b4_err, b5_errs = hold_f32_block(x, fw, d, dr, ds, False)
        bwd = lambda: fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d, causal=False)
        got, again = bwd(), bwd()
        for name, a, b in zip(B5_OUTPUTS, got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"centred B5 d={d} {name}: two calls differ")
        log(f"  centred block B={RAW_B} L={RAW_L} C_in={C_in} C={C} K={K} d={d}: two B5 calls "
            f"bit-equal; max_abs_err B4 {b4_err:.3e}, B5 {max(b5_errs):.3e}")


def raw_ctcnet_step(dev):
    """One CTC train step of train.raw_ctcnet's model (246.7 M parameters,
    Adamax, batch_standardize) at B=24, L=567 on the kernels: the launches a
    step (B4 and B5 once a block, every one centred)."""
    net = RawCTCNet(RAW_FEATURES, 3, LABELS, RAW_LAYERS, RAW_LAYERS[0][1], input_kernel_size=2,
                    softmax=False, causal=False, device=dev)
    net.reset_parameters(torch.Generator().manual_seed(SEED))
    with torch.no_grad():   # the residual stream's scale kept, as in phase 4
        for blk in [net.input_block, *net.stack.blocks]:
            blk.res_w.mul_(0.5 ** 0.5)
    tx = build_optimizer("adamax", 2e-4)
    step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
    state = TrainState.create({k: v.detach().clone() for k, v in net.state_dict().items()}, tx)
    g = torch.Generator().manual_seed(SEED + 18)
    batch = {"signal": torch.randn(RAW_B, RAW_L - 2, 1, generator=g).to(dev) * 20 + 90,
             "labels": torch.randint(1, LABELS, (RAW_B, RAW_LABELS), generator=g,
                                     dtype=torch.int32).to(dev),
             "label_lengths": torch.randint(RAW_LABELS - 9, RAW_LABELS + 1, (RAW_B,), generator=g,
                                            dtype=torch.int32).to(dev)}
    n = len(RAW_LAYERS) + 1
    _, _, launches = train_steps(step, state, batch, {
        "fused_gated_block": n, "fused_gated_block_bwd": n, "fused_gated_block_centred": n,
        "ctc_alpha": 1, "ctc_beta": 1})
    log(f"raw_ctcnet train step (B={RAW_B}, L={RAW_L - 2}, {n} centred blocks): launches a "
        f"step {launches}")


def run_centred_blocks(dev):
    """Phase 18: centred blocks on B4/B5 at train.raw_ctcnet's shapes."""
    dev = resolve_device(dev)
    phase_centred_blocks(dev)
    torch.cuda.empty_cache()
    raw_ctcnet_step(dev)
    torch.cuda.empty_cache()
    check_numerics("phase 18")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    for k, (obj, name) in _NUMERICS_FLAGS.items():   # torch's defaults: cuDNN TF32 on
        setattr(obj, name, TORCH_DEFAULTS[k])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    secs = _build.build()
    log("built kernels from the checkout: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))

    dev = torch.device("cuda")
    model = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    check_numerics("the first Model")
    log(f"CUDA numerics: torch's defaults {TORCH_DEFAULTS} before the first Model, the "
        f"port's {numerics()} after it (utils/device.py): every float32 product is full "
        f"float32, cuDNN's algorithms deterministic")
    rng = np.random.default_rng(SEED)
    reads = onehot_reads(rng, B, L, LEVELS)
    caller = Basecaller(model, beam_width=BEAM_WIDTH, logit_length_fn=lambda l: l // POOL,
                        device=dev)
    greedy = Basecaller(model, beam_width=0, logit_length_fn=lambda l: l // POOL,
                        device=dev)
    x = torch.from_numpy(np.pad(reads, ((0, 0), (0, -L % caller.pad_to_multiple), (0, 0)))
                         ).to(dev)    # (8, 4608, 256)
    S = x.shape[1]
    lengths = torch.full((B,), L // POOL, dtype=torch.int32, device=dev)
    log(f"model: WaveNet {len(WAVENET_DILS)} blocks + classifier {len(CLASSIFIER_DILS)} "
        f"blocks, {LEVELS} channels, {LABELS} labels; reads {B} x {L} "
        f"(bucketed to {S}); {sum(p.numel() for p in model.parameters())} params")

    with torch.inference_mode():
        # ---- 1. the fused block, all 30 dilations at the main-path shape
        phase_fused_block(model, model.model_base.entry(x))
        # ---- 2. the beam on the real forward's log-probs
        logits = model(x)
        if logits.shape != (B, S // POOL, LABELS) or not torch.isfinite(logits).all():
            raise AssertionError(f"logits {tuple(logits.shape)} not finite/shaped")
        phase_beam(torch.log_softmax(logits, -1), lengths, S)
        # ---- 3. at the port's init the untrained stack amplifies f32
        # rounding: the kernel forward must stay as close to the plain one as
        # the same forward on cuDNN does
        with blocks_as(fused_gated_block_ref):
            plain_logits = model(x)
        with blocks_as(cudnn_block):
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
    scale_res_w(model)

    with torch.inference_mode():
        # ---- 4. end to end through the Basecaller: the main path
        reset_counts()
        seqs, scores = caller(reads)
        launches = {k: v for k, v in read_counts().items() if v}
        log(f"main path (beam W={BEAM_WIDTH}, res_w scaled by 1/sqrt(2)): "
            f"launches {launches}")
        want = {**block_launches(model, 1), "ctc_beam": 1}
        if launches != want:
            raise AssertionError(f"main path launches {launches}: expected {want} (B4 at "
                                 f"{len(WAVENET_DILS)} causal and {len(CLASSIFIER_DILS) + 1} "
                                 f"centred blocks, 1 beam)")
        reset_counts()
        gseqs, _ = greedy(reads)
        glaunches = {k: v for k, v in read_counts().items() if v}
        if glaunches != block_launches(model, 1):
            raise AssertionError(f"greedy path launches {glaunches}")
        if not all(s and set(s) <= set("AGCT") for s in seqs + gseqs):
            raise AssertionError("empty or non-ACGT basecalls")

        stack, beam = plain_versions()
        with stack, beam:
            fused_gated_block.launches = beam_search_kernel.launches = 0
            pseqs, pscores = caller(reads)
            pgseqs, _ = greedy(reads)
            if fused_gated_block.launches or beam_search_kernel.launches:
                raise AssertionError("the plain pipeline launched a kernel")
            plain_logits = model(x)
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
    with torch.inference_mode():
        phase_padded_block(dev)
    log(f"phases 1-4: {time.perf_counter() - t_start:.1f} s")
    del model, caller, greedy, x, logits, plain_logits

    for n, run in ((5, run_training),            # the joint step at full width
                   (6, run_training_bf16),       # bf16 training at full width
                   (7, phase_train_cli),         # the train entry point
                   (8, run_parallel),            # DP and SP over torch.distributed
                   (9, run_long_read),           # chunked forwards, B6 on the carried state
                   (10, run_gauss_training),     # RawCTCNet: train, evaluate, B1/B2/B6
                   (11, run_hdf5),               # the ecoli configs through train, evaluate
                   (12, run_quality),            # the quality harness at full width
                   (13, run_multi),              # TP, RawCTCNet SP, BatchNorm over DP, decoders
                   (14, run_autoregressive),     # pretraining, generation, AR decoders
                   (15, run_last_slice),         # NPZ shards, the search, the kmer experiments
                   (16, run_multi_tensor),       # the guard and optimizer, both train trees
                   (17, run_transformer),        # Bonito's transformer
                   (18, run_centred_blocks)):    # train.raw_ctcnet's centred blocks and step
        t0 = time.perf_counter()
        run(dev)
        log(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    check_numerics("after every phase")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
