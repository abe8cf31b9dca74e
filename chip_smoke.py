#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (wavenet_speech_tpu_torch) on
one NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

It sets torch's own numerics (cuDNN TF32 on, nondeterministic cuDNN), then
checks that the port's first entry point turned them to the port's (full
float32, deterministic cuDNN; utils/device.py), that every phase left them
so, and that each rank of phase 8 gets them from make_mesh. It builds the
port's CUDA kernels from ``wavenet_speech_tpu_torch/csrc``
(and prints ptxas's registers, spills, injected waits and serialized
wgmma of the tensor-core kernels, float32 and bf16, and of the CTC and
beam kernels), then, at the full width of the bench model (WaveNet
30 blocks + classifier 18 blocks, 256 channels, 5 labels; random weights
from a seed; B=8 one-hot reads of L=4505):

  1. holds the fused gated block kernel against its plain version at every
     one of the 30 dilations, on the activations the forward feeds it;
  2. holds the prefix beam kernel against its plain version on the
     log-softmax of the real forward's logits (W=7, S=4608, lengths 1126),
     prints its time a frame at T/4, T/2 and T, and checks that two calls
     chained at T/2 through the beam state give the bits of one call;
  3. at the port's own init, holds the kernel forward's logit difference
     from the plain forward to at most SENS_FACTOR times that of the same
     forward built on cuDNN (the untrained full-width forward amplifies any
     f32 rounding difference; see PERF.md);
  4. with every block's res_w scaled by 1/sqrt(2), which keeps the residual
     stream's scale, basecalls the reads through ``Basecaller`` (beam W=7,
     then greedy), counting kernel launches, and checks the strings against
     the same pipeline run with both plain versions, and a small model
     against the CPU; then holds the causal block's four kernels (B4, B5,
     float32 and bf16) against their plain versions once each at widths
     the kernels pad (C_in=6, C=10) and K=9 taps (PAD_BLOCK);
  5. trains: the f32 joint step of bench.py:105-149 (JointLoss, Adagrad
     3e-5, the bench batch of B=8 reads, S=429 labels) at full width.
     At the port's init, and again with res_w scaled as in 4, it holds
     the kernel step's gradients to at most SENS_FACTOR times the
     cuDNN-composite step's distance from the plain step's; holds the
     fused block's backward kernel (B5) at every dilation (two calls on
     the same inputs must give the same bits) and the CTC
     alpha and beta kernels (B1, B2) against their plain versions on the
     inputs the real backward feeds them (and the CTC against
     F.ctc_loss); takes 3 steps counting launches (B4 30, B5 30, B1 1,
     B2 1 a step) and holds their updates to the same cuDNN yardstick
     against 3 steps on the plain versions; checks a small model's 3
     steps against the CPU's; and times the step.
  6. trains in bf16 (bench.py's default, compute_dtype=bf16) on the same
     model and batch: holds the bf16 forms of B4 and B5 against their plain
     bf16 versions at every dilation, on the inputs the bf16 forward and
     backward feed them; at the port's init and with res_w scaled, holds
     the bf16 kernel step's gradients to SENS_FACTOR times the bf16
     cuDNN-composite step's distance from the plain bf16 step's, and
     prints that gap by loss term and by part of the model; takes 3 bf16
     steps counting launches (B4-bf16 30, B5-bf16 30, B1 1, B2 1, no
     float32 block) with float32 params kept, holds their updates to the
     same yardstick; times the bf16 step and its kernels. At full depth
     these yardsticks cannot fail (the stack turns any flipped bf16
     rounding into an O(1) gradient change), so with the depth cut to 3+2
     blocks it holds the gradients and 3 steps' updates to
     min(SENS_FACTOR x the cuDNN composite's, BF16_GRAD_RTOL), a bound that
     zeroed causal-block gradients must fail; at 10+6 blocks it prints them.
  7. runs the port's ``train`` entry point (cli.train_with_result) on the
     model and training block of configs/ecoli_hdf5.json (256 channels,
     15+15 blocks, bf16, Adam, length-aware CTC) on the pore datatype for
     20 steps with checkpoints every 10 (written on a thread), then again
     on the same run directory: it must resume at step 20 and count on to
     40. Checks the logs, the checkpoints, finite losses, and that B4-bf16
     ran 15 times a train step and a validation forward and B5-bf16 15
     times a train step; then holds both bf16 kernels against their plain
     versions at the loop's 15 blocks and its shape (L=1090).
  8. trains on 2 ranks of one torch.distributed world (run_ranks; gloo,
     both on this card, the P2P staged through host memory), the bench
     model and batch padded to L=4608, length-aware (T=1152, 1126 live
     frames), Adagrad 3e-5, the port's numerics, res_w scaled as in 4. SP
     on a (data=1, seq=2) mesh: (b) with the depth cut to 3+2 blocks the loss
     within 1e-5 and every gradient leaf within 1e-4 (relative norm) of the
     single-device kernel step; (c) at full depth the loss within 1e-4 and
     the gradients within SENS_FACTOR x the cuDNN composite's distance; the
     main path, 3 SP train steps, each launching B4 30, B5 30, B3-fwd 1 and
     B3-bwd 1 times a rank and no whole-sequence B1/B2; (a) each rank's B3
     calls, with the carry they received and t_offset 0 or 576, against
     the plain loops, and the chained segments against B1/B2 on the whole
     sequence; (e) the step's time a rank, its halo exchanges, CTC carries
     and gradient all-reduce, B3's times. DP on a (data=2, seq=1) mesh:
     (d) 3 steps, params bit-identical across ranks, updates within
     SENS_FACTOR x the cuDNN composite's distance from 3 single-device
     steps. With 2 or more cards it runs again on NCCL, one rank a card.
  9. serves long reads: configs/gauss_quality.json's RawCTCNet at full width
     (512 features, 25 stack blocks + the input block, non-causal; res_w
     scaled as in 4, blank's bias 2 over JAX's long-read test's), B=8
     raw reads of 100,000 samples. (a) chunked_logits_batch (chunks of
     16384 samples, margin 312, groups of 8) within LONG_LOGIT_RTOL x
     max|logit| of the monolithic forward on 2 reads; (b) the main path,
     Basecaller.basecall_long_batch: one B6 launch a beam chunk of 4096
     frames from the carried state (25 a call), no saturated window, the
     streamed basecalls equal one B6 call over the same log-probs; (c) the
     first 3 chunks of 1024 frames (B6's pool in shared memory), and 2
     chunks of 4096 from (b)'s carried state mid-read (the pool in the global
     scratch, as in every call of (b)), streamed on B6 and on its plain
     version: every state equal up to plens, the committed labels and times
     equal;
     (d) the basecall command on a checkpoint of those weights, with --long
     and through the automatic switch: FASTA equal to basecall_long_batch
     through the CLI's wrapper (cli.ForwardOnly: margin 0, as the JAX CLI's
     long path stitches); (e) the bench
     model's causal WaveNet on 2 one-hot reads of 100,000 through
     chunked_logits(model.model_base, ...): B4 in every chunk forward, held
     to the monolithic base forward, and B4 at the chunk shape to its plain
     version; (f) the long call's time, reads/s and samples/s, the chunked
     forwards', B6's a chunk call and a frame, the input trie's, the
     commit's, and the peak memory.
 10. trains and scores configs/gauss_quality.json's RawCTCNet at full width
     (512 features, 25 + 1 non-causal blocks; raw-gauss data, B=6, signals
     padded to 486 samples, 488 logit frames, labels to 89; Adamax 2e-4,
     CTC loss, float32). (a) the main path: cli.train_with_result for 20
     steps, then resumed on the same run directory to 40: logs,
     checkpoints, finite losses, and B1 once a train step and a validation
     forward, B2 once a train step, no block kernel; (b) the checkpoint's
     BatchNorm mean and var against the EMA recomputed in float64 from the
     stream rebuilt from the seed; (c) B1 and B2 at this shape (J=179, one
     block a sequence) against their plain loops on the real step's inputs;
     (d) make_ctc_train_step with preprocess=batch_standardize, 3 steps on
     the kernels against 3 on the plain CTC (res_w scaled as in 4): two
     plain runs equal to the bit, the kernel steps' first gradients, params,
     updates and Adamax's mu within 1e-4 of the plain steps'; a small
     model's steps against the CPU's; (e) the evaluate command on (a)'s
     run, decoder beam (B6 once a batch) and argmax: the printed loss
     equal to the eval step on the same held-out batches, the identity to
     that of beam_search_ref's decode, to which B6 is held row for row;
     (f) the train step's and eval step's ms, the loop's samples/s, the
     decode's ms a batch, B1/B2/B6 against their bounds, and the peak
     memory; (g) two 10-step train runs from the
     config's seed in fresh run directories: checkpoints equal to the bit.
     Phases 6, 7 and 10 also time their train step with cudnn.deterministic
     switched off for that timing only: the price of the port's setting.
 11. runs the HDF5 read path. The card's machine has no h5py: the reads
     are written with h5py where it imports, else a stand-in h5py module
     serves them from memory (this script only; the port's QueueLoader,
     Dataset("hdf5") and CLI run unchanged). (a) the port's ecoli_worker_fn
     rebuilds tests/golden/realread_window.npz bit for bit from this
     script's copy of tools/make_synthetic_reads.make_read; (b) the
     real-read overfit of tests/test_realread_overfit.py in float32 (B4 and
     B5 at C=32 held, then launched 3 times a step, B1/B2 once): it must
     cross per-char CTC 0.3 and greedy-decode the bases exactly; on a read
     set of 8 reads x 4000 events, (c) configs/ecoli_hdf5_quality.json as
     it stands (15 + 15 blocks, bf16, 4 workers, K=5 steps a call on
     (5, 8, 1216) int32 levels) through train for 20 steps and a resume to
     40, launches, no StopIteration before max_iters, no producer thread
     left; B4-bf16/B5-bf16 at its 15 blocks and B1/B2 at its length-aware
     CTC against their plain versions; (d) a levels step and its one-hot
     step equal to the bit; (e) the evaluate command (beam W=7): B6 once a
     batch, the printed loss and identity equal to their recomputation on
     the batches it drew, B6 held row for row; (f) the worker's, the
     copies', the K=5 call's and the validation forward's times, the loop,
     the producers and the peak memory.
 12. runs the quality harness (python -m wavenet_speech_tpu_torch.examples.
     gaussian_eval) at the reference's full width: 2048 features, 100
     non-causal blocks of 512 channels (50 at k=2, 50 at k=3), 5 labels;
     raw-gauss B=6, signals of 567 samples, 569 logit frames, labels padded
     to 89; Adamax 2e-4, batch_standardize, float32. (a) the main path: 20
     steps into D1 in this process (B1 and B2 once a step, B1 and B6 once an
     eval batch), 10 steps into D2, D2 resumed to 20 and --eval-only on D2,
     each as a process of its own: step-20 checkpoints equal to the bit,
     three equal result JSONs, max_to_keep's step directories; (b) the
     evaluation recomputed: the per-logit CTC on the plain CTC, B6's beams
     (T=569, S = 2 x the longest label) equal to the plain beam's, the
     native C++ engine's best paths, times and scores equal to B6's, the
     identities; B1/B2 at this shape against their plain versions; (c) the
     trained params with out1.w x 1e30 dumped (dump_anomaly) and bisected
     by python -m wavenet_speech_tpu_torch.tools.bisect_nonfinite: a
     verdict at or after out1, the probed forward equal to the model's in
     bf16 and float32; (d) the float32 and bf16 steps' times, samples/s and
     peak memory, the step's parts and the card's busy share, the eval
     batch's B1, B6 and native decode, the native library's build; (e) the
     --smoke preset's 150 steps: the per-logit CTC falls, the JSON finite.

Every failure raises, so the script exits non-zero; without CUDA (or
without the package beside it) it exits non-zero before printing any
result. The second-to-last line is a JSON object of per-kernel numbers,
the last line ``{"ok": true, "device": {...}}``.
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
from wavenet_speech_tpu_torch.data.common import Batch, MuLawQuantizer
from wavenet_speech_tpu_torch.data.gaussian_kmer import DEFAULT_KMER_MODEL, kmer_ids
from wavenet_speech_tpu_torch.data.hdf5 import ecoli_worker_fn
from wavenet_speech_tpu_torch.data.prefetch import FIELDS, batch_to_device
from wavenet_speech_tpu_torch.decoding import ctc_beam_device, streaming
from wavenet_speech_tpu_torch.decoding.alignment import batch_identity
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, beam_finalize, beam_init, beam_search_kernel, beam_search_ref, ctc_beam_search)
from wavenet_speech_tpu_torch.decoding.greedy import greedy_ctc_decode, labels2strings
from wavenet_speech_tpu_torch.decoding.streaming import StreamingBeamBatch
from wavenet_speech_tpu_torch.examples import gaussian_eval
from wavenet_speech_tpu_torch.facade import Dataset, Decoder, Model
from wavenet_speech_tpu_torch.inference import (Basecaller, _chunk_grid, _default_margin,
                                                chunked_logits, chunked_logits_batch)
from wavenet_speech_tpu_torch.models import RawCTCNet, blocks
from wavenet_speech_tpu_torch.native import ctc_beam as native_beam
from wavenet_speech_tpu_torch.native import ctc_beam_search_native
from wavenet_speech_tpu_torch.ops import _build, ctc_scan
from wavenet_speech_tpu_torch.ops.activations import gated_activation
from wavenet_speech_tpu_torch.ops.ctc import (NEG, _extend_labels, _gather_ext,
                                              ctc_loss, ctc_loss_per_seq)
from wavenet_speech_tpu_torch.ops.ctc_scan import ctc_bwd, ctc_bwd_ref, ctc_fwd, ctc_fwd_ref
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref,
                                                      fused_gated_block_ref)
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.parallel import (collectives, ctc_sharded, make_mesh,
                                               run_ranks, shard_batch)
from wavenet_speech_tpu_torch.training import (JointLoss, TrainState, build_optimizer,
                                               make_eval_step, make_joint_train_step,
                                               param_tree, trainer)
from wavenet_speech_tpu_torch.training.checkpoint import (restore_checkpoint, save_checkpoint,
                                                          wait_for_async_saves)
from wavenet_speech_tpu_torch.training.diagnostics import dump_anomaly
from wavenet_speech_tpu_torch.training.trainer import (_forward_losses, all_finite,
                                                       all_reduce_grads, global_norm_safe,
                                                       make_ctc_train_step)
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

SEED = 0
B, L = 8, 4505                       # bench.py:105-149 batch and read length
LEVELS, LABELS, POOL = 256, 5, 4
WAVENET_DILS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512] * 3
CLASSIFIER_DILS = [1, 2, 4, 8, 16, 32] * 3
BEAM_WIDTH = 7
# published H100 SXM peaks (NVIDIA data sheet) at a 700 W power limit
PEAK_F32_FLOPS = 67e12               # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12             # TF32 on the tensor cores, dense
SPLIT_PRODUCTS = 3                   # TF32 products a float32-accurate split product takes
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
# bf16 (phase 6): the kernels and their plain versions round the same float32
# sums (taken in another order) to bf16, so an output may land one bf16 step
# apart: |kernel - plain| <= BF16_STEP * |plain| + the float32 term above
# (B4_ATOL, B5_WGRAD_ATOL x max|plain|); B4 also rounds act to bf16 before
# the 1x1 product, where a flipped rounding of one act value moves an output
# by one act step (<= 2^-8) times |out_w|: + 2 * 2^-8 * max|out_w|.
BF16 = torch.bfloat16
BF16_STEP = 2.0 ** -7
PEAK_BF16_FLOPS = 989e12             # bf16 on the tensor cores, dense
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
TENSOR_CORE_SOURCES = ("fused_block", "fused_block_bwd", "fused_block_bf16",
                       "fused_block_bwd_bf16")  # wgmma kernels
PTXAS_SOURCES = TENSOR_CORE_SOURCES + ("ctc", "ctc_beam")  # registers and spills printed
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


def price_determinism(label, fn, reps=5):
    """fn's ms (host clock, synchronised, mean of reps after a warm call)
    under the port's numerics and with cudnn.deterministic off, toggled here
    for this timing only, in turns: on, off, off, on."""
    ms = {True: [], False: []}
    try:
        for det in (True, False, False, True):
            torch.backends.cudnn.deterministic = det
            fn()
            ms[det].append(host_ms(fn, reps)[0])
    finally:
        torch.backends.cudnn.deterministic = True
    on, off = (sum(ms[k]) / 2 for k in (True, False))
    log(f"{label}, the price of deterministic cuDNN: {on:.3f} ms with it (the port's "
        f"setting; {ms[True][0]:.3f}, {ms[True][1]:.3f}), {off:.3f} ms without "
        f"({ms[False][0]:.3f}, {ms[False][1]:.3f}): {on / off - 1:+.1%} (host clock, "
        f"synchronised, mean of {reps} after a warm call, in turns with, without, without, "
        f"with)")


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


def start_ptxas_report(tmp):
    """A second compile of the tensor-core kernels' and the CTC kernels'
    sources with ``-Xptxas -v`` (into tmp, beside the build): their
    registers and spills."""
    return {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / f"{name}.so"),
         str(_build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in PTXAS_SOURCES}


def demangled_kernel(mangled):
    """The kernel's name in an Itanium-mangled symbol (a length-prefixed
    identifier ending in _kernel), with its template's integer argument."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel") + 1, end):
        if mangled[:end - n].endswith(str(n)):
            arg = re.match(r"IL[ib](\d+)E", mangled[end:])
            return mangled[end - n:end] + (f"<{arg[1]}>" if arg else "")
    return mangled


def log_ptxas_report(procs):
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{out}")
        kernel, injected = "?", 0
        for line in out.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = demangled_kernel(entry[1])
            elif "is injected" in line:  # C7517/C7519: a wait ptxas put between wgmmas
                injected += 1
            elif "serialized" in line:  # C7511: ptxas could not pipeline the wgmmas
                log(f"ptxas {name}.cu: {line.split(':', 1)[-1].strip()}")
            elif "Used" in line or "spill" in line:
                log(f"ptxas {name}.cu {kernel}: {line.split(':', 1)[-1].strip()}")
        log(f"ptxas {name}.cu: {injected} warpgroup waits injected by the compiler")


def f32_ops_ms(ops):
    """(CUDA-core ms, split ms) of float32 products: at the float32 rate
    outside the tensor cores, and as float32-accurate split products on the
    tensor cores (SPLIT_PRODUCTS TF32 products each)."""
    return ops / PEAK_F32_FLOPS * 1e3, SPLIT_PRODUCTS * ops / PEAK_TF32_FLOPS * 1e3


def bound_of(ops, nbytes, split=False):
    """(bound_ms, bound_by): the larger of the float32 operations over the
    peak rate and the bytes over the memory rate. split: the operations are
    matrix products, which the card can also take as split products on the
    tensor cores; the faster of the two rates counts."""
    ops_ms = min(f32_ops_ms(ops)) if split else ops / PEAK_F32_FLOPS * 1e3
    return max((ops_ms, "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"))


def bound_shares(kernel_ms, ops):
    """The text of a float32 kernel's time against both operation bounds."""
    core, split = f32_ops_ms(ops)
    return (f"share of the CUDA-core bound {core / kernel_ms:.1%} ({core:.4f} ms at "
            f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), of the split tensor-core bound "
            f"{split / kernel_ms:.1%} ({split:.4f} ms: {SPLIT_PRODUCTS} x ops at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32)")


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


def b4_work(x, gate_w):
    """B4's float32 operations and bytes on x (B, L, C_in): each input read
    once, each output written once."""
    Bx, Lx, C_in = x.shape
    K, _, C2 = gate_w.shape
    C = C2 // 2
    flops = 2 * Bx * Lx * (K * C_in * C2 + C * C2 + C_in * C)
    nbytes = 4 * (Bx * Lx * C_in + 2 * Bx * Lx * C
                  + K * C_in * C2 + C2 + C * C2 + C2 + C_in * C + C)
    return flops, nbytes


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
        rows.append(dict(
            d=d, err=err, lib_err=lib_err, scale=scale,
            ms=cuda_ms(lambda: fused_gated_block(x, *a, d), 5),
            plain_ms=cuda_ms(lambda: fused_gated_block_ref(x, *a, d), 5),
            library_ms=cuda_ms(lambda: cudnn_block(x, *a, d), 5)))
        last = (x, a, d)
        x = want[0]
    x, a, d = last
    log_kernel_times(f"B4 at d={d}", lambda: fused_gated_block(x, *a, d))
    flops, nbytes = b4_work(x_entry, model.model_base.stack.blocks[0].gate_w)
    bound_ms, bound_by = bound_of(flops, nbytes, split=True)
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
        f"bound_ms={bound_ms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s); {bound_shares(summary['ms'], flops)}; "
        f"mean over the 30 blocks")
    return summary


# B6's time a frame with the row-based kernel the prefix tree replaced, at
# the same shape (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
B6_ROWS_US_PER_FRAME = (7.536, 8.164, 9.309)


def beam_us_per_frame(lp, lengths, S):
    """B6's time a frame on the first T/4, T/2 and T frames of lp, with the
    best beam's length at the end of each: whether a frame's cost grows
    with the decoded length. The sequences run side by side, so a frame's
    time is the call's over its longest sequence's frames."""
    kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
    T, parts = lp.shape[1], []
    for n in (T // 4, T // 2, T):
        part, lens = lp[:, :n].contiguous(), lengths.clamp(max=n)
        ms = cuda_ms(lambda: beam_search_kernel(part, lens, **kw), 3)
        frames = int(lens.max())
        best = int(beam_finalize(beam_search_kernel(part, lens, **kw))[1][:, 0].max())
        parts.append(f"{frames} frames {ms * 1e3 / frames:.3f} us (best length {best})")
    log(f"B6 us a frame at T/4, T/2, T: {'; '.join(parts)} (the row-based kernel it "
        f"replaced: {', '.join(map(str, B6_ROWS_US_PER_FRAME))} us, PERF.md)")
    return ms * 1e3 / frames


def beam_chained(lp, lengths, S, one):
    """Two calls, frames [0, T/2) and then [T/2, T) from the state the first
    returned, must give the bits of one call (``one``). Then the end's cost
    alone: a call given the final state and no live frame builds its trie
    and writes the rows back."""
    kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
    T = lp.shape[1]
    t1 = T // 2
    mid = beam_search_kernel(lp[:, :t1], lengths, **kw)
    two = beam_search_kernel(lp[:, t1:], lengths, state=mid, t0=t1, **kw)
    if not all(torch.equal(x, y) for x, y in zip(two, one)):
        raise AssertionError("beam: two chained calls differ from one call")
    end_ms = cuda_ms(lambda: beam_search_kernel(lp[:, :1], lengths, state=one, t0=T, **kw), 5)
    empty_ms = cuda_ms(lambda: beam_search_kernel(lp[:, :1], lengths, **kw), 5)
    log(f"B6 chained: frames [0, {t1}) then [{t1}, {T}) from the returned state equal one "
        f"call bit for bit; a call with the final state and no live frame (trie + rows "
        f"written back) {end_ms:.4f} ms, one frame from the empty beam {empty_ms:.4f} ms "
        f"(back-to-back calls: the wrapper's host work, and with a state its read of the "
        f"lengths, included)")
    return end_ms


def b6_work(lp, lengths, S):
    """B6's operations and bytes on lp (B, T, C) with these lengths: the
    live frames' candidates scored and selected; the log-probs read once,
    the final state written once."""
    Bx, T, C = lp.shape
    N = BEAM_WIDTH * (1 + C)  # candidates a frame scores
    frames = int(lengths.clamp(max=T).sum())
    ops = frames * N * (4 + math.ceil(math.log2(N)))  # logaddexp + a selection
    nbytes = 4 * (Bx * T * C + Bx + 2 * Bx * BEAM_WIDTH * S + 3 * Bx * BEAM_WIDTH)
    return ops, nbytes


def phase_beam(lp, lengths, S):
    """B6 against its plain version on the real forward's log-probs."""
    kw = dict(beam_width=BEAM_WIDTH, max_label_len=S)
    state = beam_search_kernel(lp, lengths, **kw)
    got = beam_finalize(state)
    plain_ms, want = host_ms(lambda: beam_finalize(beam_search_ref(lp, lengths, **kw)))
    live, err = compare_beams(got, want, BEAM_WIDTH)
    ms = cuda_ms(lambda: beam_search_kernel(lp, lengths, **kw), 5)
    bound_ms, bound_by = bound_of(*b6_work(lp, lengths, S))
    us = beam_us_per_frame(lp, lengths, S)
    end_ms = beam_chained(lp, lengths, S, state)
    log(f"B6 ctc_beam: {live} live beam rows equal (prefixes, lengths, times), "
        f"max score error {err:.3e} (tolerance {BEAM_SCORE_ATOL}); "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound_ms:.6f} "
        f"({bound_by}); best length {int(want[1][0, 0])}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, us_per_frame=us, end_ms=end_ms)


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


def reset_counts():
    fused_gated_block.launches = fused_gated_block_bwd.launches = 0
    fused_gated_block.launches_bf16 = fused_gated_block_bwd.launches_bf16 = 0
    ctc_fwd.launches = ctc_bwd.launches = beam_search_kernel.launches = 0
    ctc_fwd.launches_segment = ctc_bwd.launches_segment = 0


def read_counts():
    return {"fused_gated_block": fused_gated_block.launches,
            "fused_gated_block_bwd": fused_gated_block_bwd.launches,
            "fused_gated_block_bf16": fused_gated_block.launches_bf16,
            "fused_gated_block_bwd_bf16": fused_gated_block_bwd.launches_bf16,
            "ctc_alpha": ctc_fwd.launches, "ctc_beta": ctc_bwd.launches,
            "ctc_alpha_segment": ctc_fwd.launches_segment,
            "ctc_beta_segment": ctc_bwd.launches_segment,
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


def grad_sets(model, batch, grads):
    """The gradients on the kernels, on their plain versions and on the
    cuDNN composite (the last two with the plain CTC)."""
    g_k = grads(model, batch)
    with causal_blocks_as(fused_gated_block_ref), ctc_plain():
        g_p = grads(model, batch)
    with causal_blocks_as(cudnn_block), ctc_plain():
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


def hold_b5(d, got, want):
    """B5's outputs within B4_RTOL |plain| + atol max|plain| (B4_ATOL for
    dx, B5_WGRAD_ATOL for the weight and bias gradients); returns (max abs
    errors, max|plain|s), one an output."""
    errs, scales = [], []
    for name, g, p in zip(B5_OUTPUTS, got, want):
        scale = float(p.abs().max())
        err = float((g - p).abs().max())
        atol = B4_ATOL if name == "dx" else B5_WGRAD_ATOL
        bad = int(((g - p).abs() > B4_RTOL * p.abs() + atol * scale).sum())
        if bad:
            raise AssertionError(f"B5 d={d} {name}: {bad} elements beyond tolerance; "
                                 f"max_abs_err {err:.3e}, max|plain| {scale:.3e}")
        errs.append(err)
        scales.append(scale)
    return errs, scales


def b5_work(x, gate_w):
    """B5's float32 operations and bytes on x (B, L, C_in)."""
    Bx, Lx, C_in = x.shape
    K, _, C2 = gate_w.shape
    C = C2 // 2
    n = Bx * Lx
    flops = 2 * n * (K * C_in * C2 + C2 * C          # gate recompute, da
                     + K * C2 * C_in + C * C_in      # dx
                     + K * C_in * C2 + C * C2 + C_in * C)  # weight gradients
    grads_out = K * C_in * C2 + C2 + C * C2 + C2 + C_in * C + C
    nbytes = 4 * (n * (C_in + 2 * C + C_in)          # x, dresid, dskip in; dx out
                  + K * C_in * C2 + C2 + C * C2 + C_in * C + grads_out)
    return flops, nbytes


def phase_fused_block_bwd(blocks_io):
    """B5 against its plain version at each of the 30 dilations, on the
    inputs and cotangents of the real backward; a second call on the same
    inputs must give the same bits in all seven outputs."""
    rows = []
    for x, w, d, dr, ds in blocks_io:
        got = fused_gated_block_bwd(x, *w, dr, ds, d)
        again = fused_gated_block_bwd(x, *w, dr, ds, d)
        want = fused_gated_block_bwd_ref(x, *w, dr, ds, d)
        lib_fn = cudnn_block_bwd(x, w, d, dr, ds)
        lib = lib_fn()
        torch.cuda.synchronize()
        for name, a, b in zip(B5_OUTPUTS, got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"B5 d={d} {name}: two calls on the same inputs differ")
        errs, scales = hold_b5(d, got, want)
        lib_errs = [float((c - p).abs().max()) for c, p in zip(lib, want)]
        rows.append(dict(
            d=d, errs=errs, lib_errs=lib_errs, scales=scales,
            ms=cuda_ms(lambda: fused_gated_block_bwd(x, *w, dr, ds, d), 3),
            plain_ms=cuda_ms(lambda: fused_gated_block_bwd_ref(x, *w, dr, ds, d), 3),
            library_ms=cuda_ms(lib_fn, 3)))
    flops, nbytes = b5_work(blocks_io[0][0], blocks_io[0][1][0])
    bound_ms, bound_by = bound_of(flops, nbytes, split=True)
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
        f"(dx) / {B5_WGRAD_ATOL} (weights, biases) x max|plain|, two calls bit-equal; max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in zip(B5_OUTPUTS, worst))
        + "; cuDNN-composite autograd's " + " ".join(f"{k}={e:.3e}" for k, e in
                                                      zip(B5_OUTPUTS, worst_lib))
        + f"; kernel_ms={summary['ms']:.4f} plain_ms={summary['plain_ms']:.4f} "
        f"library_ms={summary['library_ms']:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); {bound_shares(summary['ms'], flops)}; "
        f"mean over the 30 blocks")
    return summary


def log_kernel_times(label, fn, calls=3):
    """The device time of each CUDA kernel that fn() launches, by name, a
    call (torch.profiler over `calls` calls after a warm one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
            if e.device_time_total > 0 and e.count >= calls]
    total = sum(t for _, _, t in rows) / calls / 1e3
    log(f"{label} by kernel (torch.profiler, device time a call, mean of {calls}; total "
        f"{total:.4f} ms): " + "; ".join(
            f"{re.sub(r'[(].*', '', k.replace('(anonymous namespace)::', '').replace('void ', ''))}"
            f" x{n // calls} {t / calls / 1e3:.4f} ms"
            for k, n, t in sorted(rows, key=lambda r: -r[2])))


def one_block_a_sequence():
    """The CTC kernels' geometry as on a card of one SM: no cluster, one
    block a sequence (runs of 2 states, 448 threads at J=859), the
    yardstick of the cluster split."""
    geometry = ctc_scan.ctc_geometry
    return mock.patch.object(ctc_scan, "ctc_geometry",
                             lambda J, rings, B, sms: geometry(J, rings, B, 1))


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
    with one_block_a_sequence():
        one = (cuda_ms(lambda: ctc_fwd(lp, skip, lens, lab), 5),
               cuda_ms(lambda: ctc_bwd(lp, want[1], skip, lens, lab, want[0], cot), 5))
    log(f"B1, B2 on one block a sequence (no cluster): {one[0]:.4f}, "
        f"{one[1]:.4f} ms, against {ms1:.4f}, {ms2:.4f} on the launch geometry "
        f"{ctc_scan.ctc_geometry(J, 1, Bx, ctc_scan._sms(lp.device))} (R, C, threads, D)")
    lp_lib = torch.log_softmax(logits, -1).transpose(0, 1).contiguous().requires_grad_(True)
    lib_fwd_ms = cuda_ms(lambda: F.ctc_loss(lp_lib.detach(), *lib_args, reduction="sum"), 5)
    lib_loss = F.ctc_loss(lp_lib, *lib_args, reduction="sum")
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_loss, lp_lib, retain_graph=True), 5)
    states = T * Bx * J
    live = int(lens.clamp(max=T).sum()) * J
    # a live state: two logaddexps (max, sub, abs, exp, log1p, add) and two
    # adds for B1; B2 adds the occupancy (add, sub, exp, mul)
    ops1, ops2 = 14 * live, 18 * live
    bytes1 = 4 * (2 * states + 3 * Bx * J + 3 * Bx)
    bytes2 = 4 * (3 * states + 3 * Bx * J + 4 * Bx)
    out = []
    for name, ms, plain_ms, lib_ms, ops, nbytes, err in (
            ("B1 ctc_alpha", ms1, plain_fwd_ms, lib_fwd_ms, ops1, bytes1, err1),
            ("B2 ctc_beta", ms2, plain_bwd_ms, lib_bwd_ms, ops2, bytes2, err2)):
        bound_ms, bound_by = bound_of(ops, nbytes)
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


def time_training(model, step, tx, state, batch, dtype=None):
    """Step ms and samples/s from CUDA events after a warm step; forward and
    backward ms of the same objective (in dtype: None float32, or the
    step's cast); the skip guard's and the optimizer update's ms on a tree
    of the params' shapes; peak memory of the steps."""
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
        params = list(model.parameters())
        ev[0].record()
        if dtype is None:
            loss, _ = joint_loss(model, batch)
        else:
            tree = model.params()
            params = [p.requires_grad_(True) for p in tree_leaves(tree)]
            loss, _, _ = _forward_losses(model.model_base, model.model_ctc, JointLoss("joint"),
                                         tree, batch, None, dtype)
        ev[1].record()
        torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        ev[2].record()
        torch.cuda.synchronize()
        fwd += ev[0].elapsed_time(ev[1]) / 3
        bwd += ev[1].elapsed_time(ev[2]) / 3
    g = state.params
    guard_ms = cuda_ms(lambda: (global_norm_safe(g), all_finite(g)), 3)
    update_ms = cuda_ms(lambda: tx.update(g, state.opt_state, g), 3)
    log(f"train_step_ms={step_ms:.3f} samples_per_s={B * L / step_ms * 1e3:.0f} "
        f"({'f32' if dtype is None else dtype}, B={B}, L={L}, S={S_LABELS}, Adagrad; mean of "
        f"{n} steps after a warm step) forward_ms={fwd:.3f} backward_ms={bwd:.3f} skip_guard_ms={guard_ms:.3f} "
        f"optimizer_update_ms={update_ms:.3f} ({len(tree_leaves(g))} parameter tensors) "
        f"peak memory {peak / 2**30:.2f} GiB")
    return step_ms


def run_training(dev):
    batch = bench_batch(dev)
    model = Model("wavenet-ctc", cfg_full_width(), device=dev).init(SEED)
    phase_grad_ratio(model, batch, "port init")
    scale_res_w(model)         # the stream's scale kept, as in phase 4
    phase_grad_ratio(model, batch, "scaled res_w")
    blocks_io, logits, lp_ext, skip = capture_backward(model, batch)
    b5 = phase_fused_block_bwd(blocks_io)
    x, w, d, dr, ds = blocks_io[-1]   # d = 512
    log_kernel_times(f"B5 at d={d}", lambda: fused_gated_block_bwd(x, *w, dr, ds, d))
    del blocks_io
    b1, b2 = phase_ctc(lp_ext, skip, logits, batch)
    step, tx, state, launches = phase_train_steps(model, batch)
    phase_train_small(dev)
    time_training(model, step, tx, state, batch)
    return dict(b5=b5, b1=b1, b2=b2, launches=launches)


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
    rank's shard, every rank calling): each causal block's input, weights,
    dilation and output cotangents."""
    rec = []

    def recorder(x, *w_and_d):
        r, s = fused_gated_block_ref(x, *w_and_d)
        rec.append((x.detach(), [t.detach() for t in w_and_d[:-1]], w_and_d[-1], r, s))
        return r, s

    params = model.params()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with causal_blocks_as(recorder), ctc_plain():
        total, _, _ = _forward_losses(model.model_base, model.model_ctc,
                                      loss or JointLoss("joint"), params, batch,
                                      logit_length_fn, dtype, mesh)
        outs = [t for *_, r, s in rec for t in (r, s)]
        cots = torch.autograd.grad(total, outs, allow_unused=True, materialize_grads=True)
    return [(x, w, d, cots[2 * i], cots[2 * i + 1]) for i, (x, w, d, _, _) in enumerate(rec)]


def check_bf16(name, d, got, want, extra):
    """|got - want| <= BF16_STEP |want| + extra elementwise; returns the max
    absolute error."""
    diff = (got.float() - want.float()).abs()
    bad = int((diff > BF16_STEP * want.float().abs() + extra).sum())
    if bad:
        raise AssertionError(f"{name} d={d}: {bad} elements beyond tolerance; max_abs_err "
                             f"{float(diff.max()):.3e}, max|plain| {float(want.abs().max()):.3e}")
    return float(diff.max())


def check_bf16_block(x, fw, d, dr, ds):
    """B4-bf16 and B5-bf16 against their plain bf16 versions on one block's
    inputs and cotangents: bf16 out, each output within the bf16 tolerance.
    Returns (B4's max abs error, B5's per output)."""
    gw, gb, ow, ob, rw, rb = fw
    got, want = fused_gated_block(x, *fw, d), fused_gated_block_ref(x, *fw, d)
    if any(t.dtype != BF16 for t in got):
        raise AssertionError(f"B4-bf16 d={d}: outputs {[t.dtype for t in got]}")
    f_extra = B4_ATOL * max(float(w.abs().max()) for w in want) + \
        2 * 2.0 ** -8 * float(ow.abs().max())
    f_err = max(check_bf16("B4-bf16", d, g, w, f_extra) for g, w in zip(got, want))
    gotb = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d)
    wantb = fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d)
    if any(t.dtype != BF16 for t in gotb):
        raise AssertionError(f"B5-bf16 d={d}: outputs {[t.dtype for t in gotb]}")
    b_errs = [check_bf16(f"B5-bf16 {n}", d, g, w, (B4_ATOL if n == "dx" else B5_WGRAD_ATOL)
                         * float(w.float().abs().max()))
              for n, g, w in zip(B5_OUTPUTS, gotb, wantb)]
    return f_err, b_errs


def phase_bf16_kernels(blocks_io):
    """B4-bf16 and B5-bf16 against their plain bf16 versions at each of the
    30 dilations, on the inputs and cotangents of the bf16 forward and
    backward; their times beside the plain versions' and the bf16 cuDNN
    composite's (forward, and its autograd backward)."""
    rows = []
    for x, (gw, gb, ow, ob, rw, rb), d, dr, ds in blocks_io:
        fw, bw = (gw, gb, ow, ob, rw, rb), (gw, gb, ow, rw)
        f_err, b_errs = check_bf16_block(x, fw, d, dr, ds)
        lib_bwd = cudnn_block_bwd(x, bw, d, dr, ds)
        torch.cuda.synchronize()
        rows.append(dict(
            d=d, f_err=f_err, b_errs=b_errs,
            f_ms=cuda_ms(lambda: fused_gated_block(x, *fw, d), 5),
            f_plain_ms=cuda_ms(lambda: fused_gated_block_ref(x, *fw, d), 5),
            f_lib_ms=cuda_ms(lambda: cudnn_block(x, *fw, d), 5),
            b_ms=cuda_ms(lambda: fused_gated_block_bwd(x, *bw, dr, ds, d), 3),
            b_plain_ms=cuda_ms(lambda: fused_gated_block_bwd_ref(x, *bw, dr, ds, d), 3),
            b_lib_ms=cuda_ms(lib_bwd, 3)))
    Bx, Lx, C_in = blocks_io[0][0].shape
    K, _, C2 = blocks_io[0][1][0].shape
    C = C2 // 2
    n = Bx * Lx
    w_in = K * C_in * C2 + C2 + C * C2 + C2 + C_in * C + C
    # B4-bf16: every product is bf16 x bf16 (tensor cores); 2-byte tensors
    f_flops = 2 * n * (K * C_in * C2 + C * C2 + C_in * C)
    f_bytes = 2 * (n * C_in + 2 * n * C + w_in)
    # B5-bf16: the gate recompute (x Wg), da (do Wo^T), dx's residual part
    # (dresid Wr^T) and dWr (x^T dresid) multiply two bf16 values; dx's gate
    # part (dg Wg^T), dWg (x^T dg) and dWo (act^T do) take a float32 operand
    # (dg, act), which the kernel splits into bf16 hi + lo: two bf16
    # products each. All of it runs at the bf16 tensor-core rate.
    b_flops16 = 2 * n * (K * C_in * C2 + C2 * C + C * C_in + C_in * C)
    b_flops32 = 2 * n * (K * C2 * C_in + K * C_in * C2 + C * C2)
    b_bytes = 2 * (n * (C_in + 2 * C + C_in) + w_in + w_in)
    out = {}
    mean = lambda k: sum(r[k] for r in rows) / len(rows)
    for key, name, ops_ms, nbytes, err, gflop in (
            ("f", "B4-bf16 fused_gated_block_bf16", f_flops / PEAK_BF16_FLOPS * 1e3, f_bytes,
             max(r["f_err"] for r in rows), f_flops / 1e9),
            ("b", "B5-bf16 fused_gated_block_bwd_bf16",
             (b_flops16 + 2 * b_flops32) / PEAK_BF16_FLOPS * 1e3, b_bytes,
             max(max(r["b_errs"]) for r in rows), (b_flops16 + 2 * b_flops32) / 1e9)):
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
        out[key] = dict(err=err, ms=mean(f"{key}_ms"), plain_ms=mean(f"{key}_plain_ms"),
                        library_ms=mean(f"{key}_lib_ms"), bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name}: 30 dilations within {BF16_STEP} x |plain| + the float32 term; "
            f"max_abs_err={err:.3e}; kernel_ms={out[key]['ms']:.4f} "
            f"plain_ms={out[key]['plain_ms']:.4f} library_ms={out[key]['library_ms']:.4f} "
            f"(bf16 cuDNN composite{' autograd backward' if key == 'b' else ''}) "
            f"bound_ms={bound_ms:.4f} ({bound_by}: {gflop:.2f} GFLOP -> {ops_ms:.4f} ms, "
            f"{nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms); mean over the 30 blocks; "
            f"{bound_ms / out[key]['ms']:.1%} of its bound, "
            f"{out[key]['library_ms'] / out[key]['ms']:.2f}x the library's speed")
    for r in rows:
        log(f"  bf16 d={r['d']:3d} B4 err {r['f_err']:.2e} ms {r['f_ms']:.4f} | B5 err "
            + " ".join(f"{k}={e:.2e}" for k, e in zip(B5_OUTPUTS, r["b_errs"]))
            + f" ms {r['b_ms']:.4f}")
    return out


def bf16_steps(model, batch):
    """3 bf16 joint steps on the kernels (each step launches B4-bf16 and
    B5-bf16 once a causal block, B1 and B2 once, no float32 block; params
    and optimizer state stay float32), then on the plain versions and on
    the bf16 cuDNN composite from the same state. Returns (step, tx, the
    kernels' state, metrics, launches, the updates dp = p_3 - p_0 of the
    three runs)."""
    n = len(model.model_base.stack.blocks)
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 compute_dtype=BF16)
    state0 = TrainState.create(model.params(), tx)
    expect = {"fused_gated_block_bf16": n, "fused_gated_block_bwd_bf16": n,
              "ctc_alpha": 1, "ctc_beta": 1}
    state, hist, launches = train_steps(step, state0, batch, expect)
    if any(t.dtype != torch.float32 for t in tree_leaves((state.params, state.opt_state))
           if t.is_floating_point()):
        raise AssertionError("bf16 steps: params or optimizer state not float32")
    with causal_blocks_as(fused_gated_block_ref), ctc_plain():
        pstate, _, plaunch = train_steps(step, state0, batch)
    if plaunch:
        raise AssertionError(f"the plain bf16 steps launched kernels: {plaunch}")
    with causal_blocks_as(cudnn_block), ctc_plain():
        cstate, _, _ = train_steps(step, state0, batch)
    p0 = tree_leaves(state0.params)
    updates = [[a - b for a, b in zip(tree_leaves(s.params), p0)]
               for s in (state, pstate, cstate)]
    return step, tx, state, hist, launches, updates


def phase_train_steps_bf16(model, batch):
    """The bench model's 3 bf16 steps: launches, float32 state, updates to
    the cuDNN yardstick, and the bf16 losses against the float32 losses."""
    state0_params = model.params()
    step, tx, state, hist, launches, (dk, dp, dc) = bf16_steps(model, batch)
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
    return step, tx, state, launches


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
    *_, launches, (dk, dp, dc) = bf16_steps(model, batch)
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
    kernels = phase_bf16_kernels(blocks_io)
    del blocks_io
    step, tx, state, launches = phase_train_steps_bf16(model, batch)
    time_training(model, step, tx, state, batch, BF16)
    price_determinism("phase 6 bf16 train step (B=8, L=4505)", lambda: step(state, batch))
    for dils, hold in CUT_DEPTHS:
        phase_bf16_cut_depth(dev, batch, dils, hold)
    return kernels


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
    n_blocks = len(cfg["model"]["base"]["dilations"])
    counts = None
    try:
        for run, (start, end) in enumerate(((0, 20), (20, 40)), 1):
            logged = len(read_jsonl(run_dir / "logs" / "metrics.jsonl")) if run > 1 else 0
            reset_counts()
            t0 = time.perf_counter()
            result = cli.train_with_result(cfg, dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            run_counts = read_counts()
            counts = counts or run_counts
            lines = read_jsonl(run_dir / "logs" / "metrics.jsonl")[logged:]
            steps, valid = end - start, len(lines)     # one validation forward a print
            messages = (run_dir / "logs" / "messages.log").read_text()
            ckpts = sorted(int(p.name) for p in (run_dir / "ckpts").iterdir() if p.name.isdigit())
            want = {"fused_gated_block_bf16": n_blocks * (steps + valid),
                    "fused_gated_block_bwd_bf16": n_blocks * steps,
                    "fused_gated_block": 0, "fused_gated_block_bwd": 0}
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
            log(f"train entry point run {run}: steps {start + 1}-{end} in {secs:.1f} s "
                f"(model build and first-step set-up included); loop samples_per_s "
                f"{lines[-1]['samples_per_sec']:.0f} (between the prints at steps "
                f"{end - 10} and {end}); losses "
                + ", ".join(f"step {l['step']} train {l['train_loss']:.4f} valid "
                            f"{l['valid_loss']:.4f}" for l in lines)
                + f"; launches {got}; checkpoints {ckpts}")
        cli_parts(cfg, dev, run_dir / "timing")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return counts


def check_cli_kernels(model, batch, t):
    """B4-bf16 and B5-bf16 against their plain versions at each of the train
    loop's blocks, on the inputs and cotangents of one bf16 step's objective
    (the config's loss, length-aware logit lengths) at its own shape."""
    fn = model.output_length if t.get("length_aware_ctc") else None
    blocks_io = capture_blocks(model, batch, BF16, JointLoss(t.get("loss", "joint")), fn)
    f_err = b_err = 0.0
    for x, fw, d, dr, ds in blocks_io:
        f, b = check_bf16_block(x, fw, d, dr, ds)
        f_err, b_err = max(f_err, f), max(b_err, *b)
    x = blocks_io[0][0]
    log(f"train entry point: B4-bf16 and B5-bf16 at its {len(blocks_io)} blocks "
        f"(B={x.shape[0]}, L={x.shape[1]}, d={sorted({io[2] for io in blocks_io})}) within "
        f"{BF16_STEP} x |plain| + the float32 term; max_abs_err B4 {f_err:.3e}, B5 {b_err:.3e}")


def cli_parts(cfg, dev, ckpt_dir):
    """The train loop's kernels at its own shape (check_cli_kernels), and
    where a step of the loop goes (host clock, synchronised, mean of 10
    after a warm one): the pore batch's generation on the host, its copy to
    the card, the bf16 train step, a validation forward, and the host copy
    that an async checkpoint makes before its writer thread."""
    ds, model, state, (step, *_), eval_fn, t = cli.build_from_config(copy.deepcopy(cfg), dev)
    fetch_ms, b = host_ms(lambda: ds.fetch("valid"), 10)
    copy_ms, batch = host_ms(lambda: batch_to_device(b, dev), 10)
    check_cli_kernels(model, batch, t)
    box = [state]

    def one_step():
        box[0], m = step(box[0], batch)
        return m

    one_step()
    step_ms, _ = host_ms(one_step, 10)
    price_determinism(f"phase 7 train step (bf16, B={b.signal.shape[0]}, L={b.signal.shape[1]})",
                      one_step)
    eval_ms, _ = host_ms(lambda: eval_fn(box[0].params, batch), 10)
    save_ms, _ = host_ms(lambda: save_checkpoint(str(ckpt_dir), box[0], async_save=True))
    wait_for_async_saves(str(ckpt_dir))
    n = int(np.prod(b.signal.shape[:2]))
    log(f"train entry point, parts of a step (B={b.signal.shape[0]}, L={b.signal.shape[1]}): "
        f"pore batch on the host {fetch_ms:.3f} ms, copy to the card {copy_ms:.3f} ms, "
        f"bf16 train step {step_ms:.3f} ms ({n / step_ms * 1e3:.0f} samples/s), validation "
        f"forward {eval_ms:.3f} ms, async checkpoint's host copy {save_ms:.3f} ms")

# ---- 8. DP and SP over torch.distributed ---------------------------------------

SP_RANKS = 2
SP_L = 4608                  # the bench reads padded to a multiple of seq x pool x 2
SP_CUT = ([1, 2, 4], [1, 2])  # (b): the depth cut to 3+2 blocks
# (b): SP against the single-device kernel step at the cut depth: the same
# sums in another order (halo windows, shorter shards, a two-term
# all-reduce), which the cut stack barely amplifies
SP_LOSS_RTOL, SP_LEAF_RTOL = 1e-5, 1e-4
SP_FULL_LOSS_RTOL = 1e-4     # (c): full depth, res_w scaled
SP_STEPS_TIMED = 3


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


def one_rank_at_a_time(mesh, fn):
    """fn() on each rank in turn (the ranks share the card), barriers
    between; returns this rank's result."""
    out = None
    for r in range(mesh.size):
        if r == mesh.rank:
            out = fn()
            torch.cuda.synchronize()
        dist.barrier()
    return out


def check_ctc(rec, mesh, name):
    """(a) on this rank: the first step's CTC calls (B3: with the carry
    they received and their t_offset; B1/B2 under DP) against the plain
    loops on the same inputs; their times (one rank at a time) and
    bounds."""
    (fa, (ll, alphas, a_out)), (ba, (grad, lpb_out)) = rec["fwd"][0], rec["bwd"][0]

    def run():
        f_ms, want = host_ms(lambda: ctc_fwd_ref(*fa))
        b_ms, wantb = host_ms(lambda: ctc_bwd_ref(*ba))
        return (f_ms, want, b_ms, wantb, cuda_ms(lambda: ctc_fwd(*fa), 5),
                cuda_ms(lambda: ctc_bwd(*ba), 5))

    plain_f, want, plain_b, wantb, ms_f, ms_b = one_rank_at_a_time(mesh, run)
    err_f = max(check_close(f"{name}-fwd {n}", g, w, CTC_RTOL, CTC_ATOL)
                for n, g, w in zip(("ll", "alphas", "alpha_out"), (ll, alphas, a_out), want))
    err_b = max(check_close(f"{name}-bwd grad", grad, wantb[0], CTC_GRAD_RTOL, CTC_GRAD_ATOL),
                check_close(f"{name}-bwd lpb_out", lpb_out, wantb[1], CTC_RTOL, CTC_ATOL))
    lp, lens = fa[0], fa[2]
    t_offset = fa[5] if len(fa) > 5 else 0
    Tl, Bx, J = lp.shape
    live = int((lens.long() - t_offset).clamp(0, Tl).sum()) * J   # this run's live states
    out = {}
    # as phase 5's B1/B2: 14 operations a live state (fwd), 18 (bwd); each
    # (T, B, J) tensor and each carry read or written once
    for key, ms, plain_ms, err, ops, nbytes in (
            ("fwd", ms_f, plain_f, err_f, 14 * live, 4 * (2 * Tl * Bx * J + 3 * Bx * J + 3 * Bx)),
            ("bwd", ms_b, plain_b, err_b, 18 * live, 4 * (3 * Tl * Bx * J + 3 * Bx * J + 4 * Bx))):
        bound_ms, bound_by = bound_of(ops, nbytes)
        out[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, mb=nbytes / 1e6)
    if len(fa) > 5:   # B3: for the chain check against B1/B2 on the whole sequence
        out["chain"] = dict(lp=lp, skipadd=fa[1], lens=lens, lab=fa[3], ll=ba[5], cot=ba[6],
                            grad=grad, t_offset=t_offset,
                            alpha_in_live=bool((fa[4] > NEG / 2).any()))
    return out


def check_blocks(blocks_io, mesh):
    """B4 and B5 against their plain versions at each causal block of the
    objective on this rank (SP: the [halo | shard] window; DP: the rank's
    reads), within phase 1's and phase 5's tolerances; their times (one
    rank at a time, mean over the blocks) and bounds (the same mean)."""
    b4_err, b5_err = 0.0, [0.0] * len(B5_OUTPUTS)
    for x, fw, d, dr, ds in blocks_io:
        w = (fw[0], fw[1], fw[2], fw[4])   # gate_w, gate_b, out_w, res_w
        b4_err = max(b4_err, hold_b4(d, fused_gated_block(x, *fw, d),
                                     fused_gated_block_ref(x, *fw, d))[0])
        errs, _ = hold_b5(d, fused_gated_block_bwd(x, *w, dr, ds, d),
                          fused_gated_block_bwd_ref(x, *w, dr, ds, d))
        b5_err = [max(a, b) for a, b in zip(b5_err, errs)]

    def run():
        ms = {"b4": 0.0, "b4_plain": 0.0, "b5": 0.0, "b5_plain": 0.0}
        for x, fw, d, dr, ds in blocks_io:
            w = (fw[0], fw[1], fw[2], fw[4])
            ms["b4"] += cuda_ms(lambda: fused_gated_block(x, *fw, d), 2)
            ms["b4_plain"] += cuda_ms(lambda: fused_gated_block_ref(x, *fw, d), 2)
            ms["b5"] += cuda_ms(lambda: fused_gated_block_bwd(x, *w, dr, ds, d), 2)
            ms["b5_plain"] += cuda_ms(lambda: fused_gated_block_bwd_ref(x, *w, dr, ds, d), 2)
        return {k: v / len(blocks_io) for k, v in ms.items()}

    out = one_rank_at_a_time(mesh, run)
    for key, work in (("b4", b4_work), ("b5", b5_work)):
        ops, nbytes = (sum(v) / len(blocks_io)
                       for v in zip(*(work(x, fw[0]) for x, fw, *_ in blocks_io)))
        out[f"{key}_bound"] = bound_of(ops, nbytes, split=True)
    x = blocks_io[0][0]
    out.update(b4_err=b4_err, b5_err=b5_err, n=len(blocks_io), B=x.shape[0],
               L=sorted({io[0].shape[1] for io in blocks_io}))
    return out


def log_blocks(label, r):
    """One rank's check_blocks result."""
    log(f"{label}: B4 and B5 at its {r['n']} causal blocks (B={r['B']}, L={r['L'][0]}.."
        f"{r['L'][-1]}) within rtol {B4_RTOL}, atol {B4_ATOL} / {B5_WGRAD_ATOL} x max|plain|; "
        f"max_abs_err B4 {r['b4_err']:.3e}, B5 "
        + " ".join(f"{k}={e:.2e}" for k, e in zip(B5_OUTPUTS, r["b5_err"]))
        + f"; mean ms B4 {r['b4']:.4f} (plain {r['b4_plain']:.4f}, bound "
        f"{r['b4_bound'][0]:.4f} {r['b4_bound'][1]}), B5 {r['b5']:.4f} (plain "
        f"{r['b5_plain']:.4f}, bound {r['b5_bound'][0]:.4f} {r['b5_bound'][1]})")


def timed(fn, box):
    """fn with its host time (synchronised before and after) added to box."""
    def call(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        box.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def sp_rank(device):
    """One rank of phase 8 (module-level: run_ranks spawns it). SP on a
    (data=1, seq=2) mesh: (b) the cut-depth gradients, (c) the full-depth
    gradients, B4/B5 against their plain versions on the halo windows, the
    main path (3 SP train steps, launches counted, B3's calls recorded),
    (a) B3 against its plain version, (e) times; then DP on a (data=2,
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
                                                logit_frames, mesh), mesh)
    # the main path: the SP train step, counts zeroed and read each step
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 logit_length_fn=logit_frames, mesh=mesh)
    state = TrainState.create(model.params(), tx)
    n = len(WAVENET_DILS)
    expect = {"fused_gated_block": n, "fused_gated_block_bwd": n,
              "ctc_alpha_segment": 1, "ctc_beta_segment": 1}
    with record_ctc() as rec:
        state, hist, launches = train_steps(step, state, batch, expect)
    out.update(launches=launches, losses=[h["total_loss"] for h in hist])
    out["b3"] = check_ctc(rec, mesh, "B3")
    del rec
    # (e) the step's time, then one step with its exchanges timed
    step_ms, _ = host_ms(lambda: step(state, batch), SP_STEPS_TIMED)
    halo, carry, reduce = [], [], []
    with mock.patch.object(collectives, "p2p", timed(collectives.p2p, halo)), \
            mock.patch.object(ctc_sharded, "p2p", timed(ctc_sharded.p2p, carry)), \
            mock.patch.object(trainer, "all_reduce_grads", timed(trainer.all_reduce_grads, reduce)):
        step(state, batch)
    out["times"] = dict(step_ms=step_ms, halo_ms=sum(halo), halo_n=len(halo),
                        carry_ms=sum(carry), carry_n=len(carry), all_reduce_ms=sum(reduce),
                        grad_mb=4 * sum(p.numel() for p in tree_leaves(state.params)) / 1e6)
    del model, step, state
    # (d) DP: 4 reads a rank, full depth, 3 Adagrad steps
    dmesh = make_mesh(data=SP_RANKS, seq=1, device=device)
    model = sp_model(dev)
    batch = shard_batch(dmesh, batch_g)
    blocks_dp = check_blocks(capture_blocks(model, batch, None, JointLoss("joint"),
                                            logit_frames, dmesh), dmesh)
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 logit_length_fn=logit_frames, mesh=dmesh)
    with record_ctc() as rec:
        state, hist, dp_launches = train_steps(step, TrainState.create(model.params(), tx),
                                               batch, {"fused_gated_block": n,
                                                       "fused_gated_block_bwd": n,
                                                       "ctc_alpha": 1, "ctc_beta": 1})
    out["dp"] = dict(mesh=repr(dmesh), params=tree_leaves(state.params), launches=dp_launches,
                     losses=[h["total_loss"] for h in hist], blocks=blocks_dp,
                     ctc=check_ctc(rec, dmesh, "B1/B2"))
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
    with causal_blocks_as(cudnn_block), ctc_plain():
        ref["full_cudnn"] = objective_grads(model, batch)
    tx = build_optimizer("adagrad", TRAIN_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"),
                                 logit_length_fn=logit_frames)
    state0 = TrainState.create(model.params(), tx)
    ref["p0"] = tree_leaves(state0.params)
    ref["dp"] = tree_leaves(train_steps(step, state0, batch)[0].params)
    with causal_blocks_as(cudnn_block), ctc_plain():
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


def run_parallel(dev, card):
    """Phase 8: SP and DP on 2 gloo ranks on this card, held to single-device
    runs on the card; with 2 or more cards, SP and DP again on NCCL, one
    rank a card. card: nvidia-smi's name and power limit, printed beside
    the times. Returns the B3 rows of the kernels line."""
    t0 = time.perf_counter()
    ref = sp_references(dev)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = run_ranks(sp_rank, SP_RANKS, "gloo", str(dev), timeout=600)
    ranks = [tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t, r) for r in ranks]
    secs = time.perf_counter() - t1
    log(f"phase 8: single-device references {t1 - t0:.1f} s; {SP_RANKS} ranks {secs:.1f} s "
        f"(spawn and set-up included); backend: "
        f"{ranks[0]['transport']}: {SP_RANKS} ranks on 1 card; meshes {ranks[0]['mesh']}, "
        f"{ranks[0]['dp']['mesh']}")
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
            f"{b['fwd']['err']:.3e} kernel_ms={b['fwd']['ms']:.4f} plain_ms="
            f"{b['fwd']['plain_ms']:.1f} bound_ms={b['fwd']['bound_ms']:.6f} "
            f"({b['fwd']['bound_by']}, {b['fwd']['mb']:.1f} MB); B3-bwd max_abs_err "
            f"{b['bwd']['err']:.3e} kernel_ms={b['bwd']['ms']:.4f} plain_ms="
            f"{b['bwd']['plain_ms']:.1f} bound_ms={b['bwd']['bound_ms']:.6f} "
            f"({b['bwd']['bound_by']}, {b['bwd']['mb']:.1f} MB)")
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
            f"against their plain loops: max_abs_err {c['fwd']['err']:.3e}, "
            f"{c['bwd']['err']:.3e}; kernel_ms {c['fwd']['ms']:.4f}, {c['bwd']['ms']:.4f} "
            f"(plain {c['fwd']['plain_ms']:.1f}, {c['bwd']['plain_ms']:.1f}; bound "
            f"{c['fwd']['bound_ms']:.6f}, {c['bwd']['bound_ms']:.6f})")
    # (e) times
    for i, r in enumerate(ranks):
        t = r["times"]
        log(f"(e) rank {i}: SP train step {t['step_ms']:.1f} ms (mean of {SP_STEPS_TIMED}, "
            f"host clock, synchronised; both ranks share the card); in one instrumented step "
            f"{t['halo_n']} halo exchanges {t['halo_ms']:.1f} ms, {t['carry_n']} CTC carries "
            f"{t['carry_ms']:.1f} ms, the gradient all-reduce ({t['grad_mb']:.1f} MB) "
            f"{t['all_reduce_ms']:.1f} ms; card {card}")
    if torch.cuda.device_count() >= 2:
        nccl = run_ranks(sp_rank, SP_RANKS, "nccl", None, timeout=600)
        log(f"nccl: {nccl[0]['transport']}, one rank a card: (c) launches "
            f"{[r['launches'] for r in nccl]}, step {[round(r['times']['step_ms'], 1) for r in nccl]} ms")
    else:
        log("nccl: not run (1 device)")
    rows = []
    for key, name, line in (("fwd", "B3-fwd", 335), ("bwd", "B3-bwd", 355)):
        mean = lambda k: sum(r["b3"][key][k] for r in ranks) / len(ranks)
        counts = {r["launches"].get(f"ctc_{'alpha' if key == 'fwd' else 'beta'}_segment", 0)
                  for r in ranks}
        rows.append(dict(
            name=name, route="cuda", source="wavenet_speech_tpu_torch/csrc/ctc.cu",
            replaces=f"wavenet_speech_tpu/ops/pallas/ctc.py:{line}", launches=counts.pop(),
            max_abs_err=max(r["b3"][key]["err"] for r in ranks), ms=mean("ms"),
            plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=ranks[0]["b3"][key]["bound_by"], library_ms=None))
    return rows


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


def gauss_model(dev):
    """configs/gauss_quality.json's RawCTCNet at full width from the seed,
    res_w scaled by 1/sqrt(2) (phase 4)."""
    cfg = json.loads(LONG_CONFIG.read_text())
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
        ms, chunked = host_ms(lambda: torch.stack(
            [chunked_logits(base, r, LONG_CHUNK, chunk_batch=LONG_CHUNK_BATCH) for r in reads]))
        launches = fused_gated_block.launches
        groups = LONG_MONO_READS * math.ceil(len(starts) / LONG_CHUNK_BATCH)
        if launches != len(WAVENET_DILS) * groups or read_counts()["ctc_beam"]:
            raise AssertionError(f"(e) B4 launched {launches} times: expected "
                                 f"{len(WAVENET_DILS)} blocks x {groups} chunk groups")
        err, _ = hold_logits(f"(e) causal WaveNet ({len(WAVENET_DILS)} blocks, {LEVELS} "
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
        f"{LONG_CHUNK_BATCH} chunks); chunked forwards of {LONG_MONO_READS} reads {ms:.1f} ms "
        f"(host clock); B4 at the chunk shape ({LONG_CHUNK_BATCH}, {LONG_CHUNK}, {LEVELS}) "
        f"within phase 1's tolerance at all {len(WAVENET_DILS)} blocks, max_abs_err "
        f"{b4_err:.3e}")
    return dict(launches=launches, err=err)


def run_long_read(dev, card):
    """Phase 9: long reads through Basecaller.basecall_long_batch (chunked
    forwards + the streaming beam, B6 with the state carried), the basecall
    command, and a causal WaveNet's chunked forwards (B4). card: nvidia-smi's
    name and power limit, printed beside the times."""
    t0 = time.perf_counter()
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
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        # ---- (a) the chunked forwards against the monolithic forward
        logits = chunked_logits_batch(model, sig, LONG_CHUNK, chunk_batch=LONG_CHUNK_BATCH)
        if logits.shape != (LONG_B, T, LABELS) or not torch.isfinite(logits).all():
            raise AssertionError(f"(a) logits {tuple(logits.shape)} not finite/shaped")
        a_err, _ = hold_logits(f"(a) chunked_logits_batch ({LONG_B * len(starts)} chunk "
                               f"forwards) against the monolithic forward",
                               logits[:LONG_MONO_READS], model(sig[:LONG_MONO_READS]))
        lp = torch.log_softmax(logits, -1)
        # ---- (b) the main path: the long call, B6 on the carried state
        reset_counts()
        seqs, scores = caller.basecall_long_batch(reads[..., None], **long_kw)
        launches = {k: v for k, v in read_counts().items() if v}
        want_launches = {"ctc_beam": math.ceil(T / LONG_BEAM_FRAMES)}
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
            plain_ms, (on_plain, _) = host_ms(lambda: stream_chunks(lp, True, frames, chunks,
                                                                    first))
            if read_counts()["ctc_beam"] != chunks:
                raise AssertionError(f"{c_label} the plain stream launched B6")
            live_rows, committed, c_err = compare_streams(c_label, on_kernel, on_plain)
            t_first = 0 if first is None else first.frames_fed
            log(f"{c_label} {chunks} chunks of ({LONG_B}, {frames}, {LABELS}) from frame "
                f"{t_first} (B6's pool in {'shared memory' if in_shared else 'the global scratch'}"
                f"), streamed on B6 and on its plain version ({plain_ms / 1e3:.1f} s): every "
                f"chunk's {live_rows // chunks} live rows equal up to plens, {committed} "
                f"committed labels and their times equal, max score error {c_err:.3e}")
        # ---- (f) times
        call_ms, _ = host_ms(lambda: caller.basecall_long_batch(reads[..., None], **long_kw))
        fwd_ms, _ = host_ms(lambda: chunked_logits_batch(model, sig, LONG_CHUNK,
                                                         chunk_batch=LONG_CHUNK_BATCH))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sbb = StreamingBeamBatch(LONG_B, [T] * LONG_B, beam_width=BEAM_WIDTH,
                                 label_window=LONG_WINDOW, device=dev)
        sbb.feed(lp[:, :LONG_BEAM_FRAMES])
        kw = dict(beam_width=BEAM_WIDTH, max_label_len=LONG_WINDOW, state=sbb.state)
        chunk = lp[:, LONG_BEAM_FRAMES: 2 * LONG_BEAM_FRAMES].contiguous()
        b6_ms = cuda_ms(lambda: beam_search_kernel(chunk, lengths, t0=LONG_BEAM_FRAMES, **kw), 3)
        trie_ms = cuda_ms(lambda: beam_search_kernel(chunk[:, :1], lengths, t0=T, **kw), 5)
        raw = beam_search_kernel(chunk, lengths, t0=LONG_BEAM_FRAMES, **kw)
        commit_ms, _ = host_ms(lambda: streaming.commit(raw, LONG_WINDOW), 5)
        n_in = 1 + int(sbb.state[1].clamp(min=0).sum(1).max())
        b6_pool = ("shared memory" if pool_in_shared(sbb.state, LONG_BEAM_FRAMES)
                   else "the global scratch")
    log(f"(f) long call {call_ms:.1f} ms ({LONG_B / call_ms * 1e3:.2f} reads/s, "
        f"{LONG_B * LONG_L / call_ms * 1e3:.0f} samples/s; host clock, one call after a warm "
        f"one); its chunked forwards alone {fwd_ms:.1f} ms; B6 {b6_ms:.3f} ms a chunk call of "
        f"{LONG_BEAM_FRAMES} frames from a carried state ({b6_ms * 1e3 / LONG_BEAM_FRAMES:.3f} "
        f"us a frame; pool {n_in} input nodes + {BEAM_WIDTH} x {LONG_BEAM_FRAMES}, in "
        f"{b6_pool}), a call "
        f"with the carried state and no live frame (input trie, rows written back) "
        f"{trie_ms:.4f} ms; the commit {commit_ms:.3f} ms a chunk (host clock, its copy to "
        f"the host included); peak memory {peak:.2f} GiB; card {card}")
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
    del model, caller, logits, lp, sig, raw, sbb, start
    torch.cuda.empty_cache()
    # ---- (e) a causal WaveNet's chunked forwards: B4 in every chunk
    e = phase_long_wavenet(dev)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return dict(b6_launches=launches["ctc_beam"], b4_launches=e["launches"])


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
    validation forward B1 once, no block kernel. Returns the first run's
    launches and its loop samples/s."""
    counts, rates = None, []
    for run, (start, end) in enumerate(((0, GAUSS_STEPS), (GAUSS_STEPS, 2 * GAUSS_STEPS)), 1):
        logged = len(read_jsonl(run_dir / "logs" / "metrics.jsonl")) if run > 1 else 0
        reset_counts()
        t0 = time.perf_counter()
        result = cli.train_with_result(copy.deepcopy(cfg), dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run_counts = {k: v for k, v in read_counts().items() if v}
        counts = counts or run_counts
        lines = read_jsonl(run_dir / "logs" / "metrics.jsonl")[logged:]
        steps, valid = end - start, len(lines)
        messages = (run_dir / "logs" / "messages.log").read_text()
        ckpts = sorted(int(p.name) for p in (run_dir / "ckpts").iterdir() if p.name.isdigit())
        want = {"ctc_alpha": steps + valid, "ctc_beta": steps}
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
        rates.append(lines[-1]["samples_per_sec"])
        log(f"(a) train run {run}: steps {start + 1}-{end} in {secs:.1f} s (model build and "
            f"first-step set-up included); loop samples_per_s {rates[-1]:.0f} (between the "
            f"prints at steps {end - GAUSS_PRINT} and {end}); losses "
            + ", ".join(f"step {l['step']} train {l['train_loss']:.4f} valid "
                        f"{l['valid_loss']:.4f}" for l in lines)
            + f"; launches {run_counts}; checkpoints {ckpts}")
    return counts, rates


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

    def record(st, total, g, tx_):
        if not grads:
            grads.append([t.clone() for t in tree_leaves(g)])
        return guarded(st, total, g, tx_)

    with (ctc_plain() if plain else contextlib.nullcontext()), \
            mock.patch.object(trainer, "_guarded_update", record):
        state, hist, launches = train_steps(step, state, batch,
                                            None if plain else {"ctc_alpha": 1, "ctc_beta": 1})
    if plain and launches:
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
    """(g) C2 end to end: cli.train_with_result on configs/gauss_quality.json
    from its seed, REPRO_STEPS steps, twice, each in a fresh run directory;
    the two final checkpoints must be equal to the bit."""
    payloads, t0 = [], time.perf_counter()
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
        raise AssertionError(f"(g) two train runs from one seed differ (C2): {len(differ)} of "
                             f"{len(a)} checkpoint leaves, params {rel_err(pb, pa):.3e} apart")
    log(f"(g) two {REPRO_STEPS}-step train runs of configs/gauss_quality.json from its seed, "
        f"each in a fresh run directory: final checkpoints equal to the bit ({len(a)} leaves: "
        f"params, Adamax's state, step; {time.perf_counter() - t0:.1f} s)")


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
    argmax and CTC collapse written out here, not the port's decoder). Returns B6's numbers
    at this shape and the decode times."""
    out, ref_ids, ref_ids_argmax, losses, b6 = {}, [], [], [], None
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
        plain_ms, want = host_ms(lambda: beam_finalize(beam_search_ref(lp, lengths, **kw)))
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
            ms = cuda_ms(lambda: beam_search_kernel(lp, lengths, **kw), 5)
            bound_ms, bound_by = bound_of(*b6_work(lp, lengths, T))
            beam_ms, _ = host_ms(lambda: Decoder("beam", BEAM_WIDTH).decode(logits, lengths), 3)
            argmax_ms, _ = host_ms(lambda: Decoder("argmax").decode(logits, lengths), 3)
            b6 = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                      shape=f"B={lp.shape[0]} T={T} C={lp.shape[2]} W={BEAM_WIDTH} S={T}",
                      beam_ms=beam_ms, argmax_ms=argmax_ms)
    want_loss = float(np.mean(losses))
    for decoder, ids in (("beam", ref_ids), ("argmax", ref_ids_argmax)):
        c = copy.deepcopy(cfg)
        c["training"]["decoder"] = decoder
        path = run_dir / f"evaluate_{decoder}.json"
        path.write_text(json.dumps(c))
        n, loss, ident, launches, line = run_evaluate(path, decoder)
        want_launches = {"ctc_alpha": GAUSS_EVAL_BATCHES}
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
        out[decoder] = launches
        log(f"(e) evaluate, decoder {decoder}: {line!r}; launches {launches}; the eval step "
            f"recomputed {want_loss:.6f}, the identity of the plain decode {want_ident}")
    log(f"(e) B6 at {b6['shape']}: every live row of the {GAUSS_EVAL_BATCHES} batches equal "
        f"to beam_search_ref's (max score error {err:.3e}); kernel_ms={b6['ms']:.4f} "
        f"plain_ms={b6['plain_ms']:.1f} bound_ms={b6['bound_ms']:.6f} ({b6['bound_by']}); "
        f"Decoder.decode a batch: beam {b6['beam_ms']:.3f} ms, argmax {b6['argmax_ms']:.3f} ms "
        f"(host clock, copies to the host included)")
    b6.update(err=err, launches=out["beam"]["ctc_beam"])
    return b6


def gauss_step_parts(model, step, state, batch):
    """(f) Where the train step goes: the forward (CTC loss included) and
    the backward (CUDA events, mean of 3), the skip guard and Adamax's
    update on a tree of the params' shapes (CUDA events), the step on the
    host clock (mean of 5, synchronised), and the card's busy share over 3
    steps: the CUDA kernels' summed device time (torch.profiler) over the
    steps' host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fwd = bwd = 0.0
    for _ in range(3):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        ev[0].record()
        loss, _, _ = _forward_losses(model.model_base, model.model_ctc, JointLoss("ctc"),
                                     params, batch, None, None)
        ev[1].record()
        torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        ev[2].record()
        torch.cuda.synchronize()
        fwd += ev[0].elapsed_time(ev[1]) / 3
        bwd += ev[1].elapsed_time(ev[2]) / 3
    g = state.params
    tx = build_optimizer("adamax", GAUSS_LR)
    guard_ms = cuda_ms(lambda: (global_norm_safe(g), all_finite(g)), 3)
    update_ms = cuda_ms(lambda: tx.update(g, state.opt_state, g), 3)
    box = [state]

    def one_step():
        box[0], m = step(box[0], batch)
        return m

    host_step_ms, _ = host_ms(one_step, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = host_ms(one_step, 3)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 3 / 1e3
    log(f"(f) parts of a train step: forward {fwd:.3f} ms, backward {bwd:.3f} ms (CUDA "
        f"events), skip guard {guard_ms:.3f} ms, Adamax update {update_ms:.3f} ms "
        f"({len(tree_leaves(g))} parameter tensors); the step on the host clock "
        f"{host_step_ms:.3f} ms; the card busy {busy_ms:.3f} of {wall_ms:.3f} ms a step "
        f"({busy_ms / wall_ms:.1%}; idle {1 - busy_ms / wall_ms:.1%}; torch.profiler)")


def run_gauss_training(dev, card):
    """Phase 10: configs/gauss_quality.json trained through the train
    command and scored through evaluate, make_ctc_train_step at its width,
    B1/B2 and B6 at its shapes. card: nvidia-smi's name and power limit."""
    t0 = time.perf_counter()
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_gauss_"))
    try:
        cfg = gauss_cfg(run_dir)
        raw, tr = cfg["model"]["raw"], cfg["training"]
        log(f"phase 10 model: configs/gauss_quality.json's RawCTCNet ({raw['num_features']} "
            f"features, {raw['num_dilation_blocks']} x {raw['dilations']} blocks + the input "
            f"block, causal {raw['causal']}), {tr['datatype']} B={tr['batch_size']}, "
            f"{GAUSS_STEPS} steps a run")
        # ---- (a) the main path: the train command, then resumed
        counts, rates = gauss_train_runs(cfg, run_dir, dev)
        ds, model, state, (step, *_), eval_fn, t = cli.build_from_config(
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
        b1, b2 = phase_ctc(lp_ext, skip, logits, batch)
        # ---- (f) the train step, the eval step, peak memory
        box = [state]

        def one_step():
            box[0], m = step(box[0], batch)
            return m

        one_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(one_step, 5, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        price_determinism("phase 10 float32 train step (B=6, L=486)", one_step)
        eval_ms = cuda_ms(lambda: eval_fn(state.params, batch), 5)
        n = int(np.prod(b.signal.shape[:2]))
        log(f"(f) train_step_ms={step_ms:.3f} samples_per_s={n / step_ms * 1e3:.0f} (B=6, "
            f"L={b.signal.shape[1]}, T={T}, Adamax, float32, TF32 off; CUDA events, mean of 5 "
            f"after a warm step) eval_step_ms={eval_ms:.3f}; loop samples_per_s "
            f"{rates[0]:.0f} / {rates[1]:.0f} (runs 1 / 2); peak memory {peak:.2f} GiB; "
            f"card {card}")
        gauss_step_parts(model, step, state, batch)
        # ---- (e) the evaluate command
        b6 = phase_evaluate(cfg, run_dir, model, state, eval_fn)
        del model, state, box, ds, logits, lp_ext
        torch.cuda.empty_cache()
        # ---- (d) make_ctc_train_step at full width
        phase_ctc_step(dev, batch)
        # ---- (g) two train runs from one seed
        reproducible_train_runs(dev)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    shape = f"B={Bx} T={T} J={J}"
    return dict(b1=dict(b1, launches=counts["ctc_alpha"], shape=shape),
                b2=dict(b2, launches=counts["ctc_beta"], shape=shape), b6=b6)


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


class ReadSetFile:
    """What the port's ecoli_worker_fn and QueueLoader use of an h5py.File
    opened for reading (keys(), [] and close()), over reads in memory in the
    /read_i/{quantized, raw/positions, reference} layout."""

    def __init__(self, reads):
        self.groups = {}
        for i, (bases, positions, chunks) in enumerate(reads):
            quantized = np.empty(len(chunks), dtype=object)
            for j, c in enumerate(chunks):
                quantized[j] = c
            self.groups[f"read_{i}"] = {"quantized": quantized,
                                        "raw": {"positions": positions}, "reference": bases}

    def keys(self):
        return self.groups.keys()

    def __getitem__(self, key):
        return self.groups[key]

    def close(self):
        pass


@contextlib.contextmanager
def reads_file(path, reads):
    """A file at path holding reads in the layout of
    tools/make_synthetic_reads.py, for the port's own ``h5py.File`` calls:
    written with h5py where it imports; else, as on a machine without h5py,
    a stand-in h5py module whose File(path) serves the reads from memory
    sits in sys.modules until the block ends. Yields which of the two ran."""
    try:
        h5py = importlib.import_module("h5py")
    except ImportError:
        h5py = None
    if h5py is not None:
        with h5py.File(path, "w") as f:
            for i, (bases, positions, chunks) in enumerate(reads):
                g = f.create_group(f"read_{i}")
                g.create_dataset("quantized", (len(chunks),),
                                 dtype=h5py.vlen_dtype(np.dtype("int64")))[:] = chunks
                g.create_group("raw").create_dataset("positions", data=positions)
                g.create_dataset("reference", data=bases)
        yield f"h5py {h5py.__version__}: a file written"
        return
    served, stand_in = ReadSetFile(reads), types.ModuleType("h5py")

    def open_file(name, mode="r"):
        if str(name) != str(path) or mode != "r":
            raise OSError(f"the stand-in h5py opens only {path}, for reading")
        return served

    stand_in.File = open_file
    sys.modules["h5py"] = stand_in
    try:
        yield "no h5py here: a stand-in h5py module serving the reads from memory"
    finally:
        del sys.modules["h5py"]


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


def hold_f32_blocks(blocks_io):
    """B4 and B5 (float32) against their plain versions on each captured
    block's inputs and cotangents (phases 1 and 5's tolerances); returns
    their max abs errors."""
    f_err = b_err = 0.0
    with torch.no_grad():
        for x, (gw, gb, ow, ob, rw, rb), d, dr, ds in blocks_io:
            fw = (gw, gb, ow, ob, rw, rb)
            err, _ = hold_b4(d, fused_gated_block(x, *fw, d), fused_gated_block_ref(x, *fw, d))
            errs, _ = hold_b5(d, fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d),
                              fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d))
            f_err, b_err = max(f_err, err), max(b_err, *errs)
    return f_err, b_err


def overfit_realread(dev, fx):
    """(b) tests/test_realread_overfit.py on the card, float32: the joint
    WaveNet-CTC (256 levels, WaveNet (32, 32, 2, d) for d = 1, 2, 4, a
    classifier of 6 such blocks, pool 1), Adam 2e-3, on the fixture's levels
    batch, one-hot in the step; at most 2500 steps, stopping below per-char
    CTC 0.02. It must cross 0.3 and greedy-decode the read's bases exactly.
    B4 and B5 (float32) launch 3 times a step, B1 and B2 once; both block
    kernels are held at C = 32 on the first step's inputs first."""
    layers = [[OVERFIT_C, OVERFIT_C, 2, d] for d in (1, 2, 4)]
    cfg = {"model": {"base": {"signal_dim": LEVELS, "entry_kwidth": 2, "layers": layers},
                     "classifier": {"num_labels": LABELS, "layers": layers * 2,
                                    "out_dim": OVERFIT_C, "downsample": 1}}}
    model = Model("wavenet-ctc", cfg, device=dev).init(SEED)
    batch = {k: torch.from_numpy(fx[k].astype(np.int32)).to(dev) for k in FIELDS}
    f_err, b_err = hold_f32_blocks(capture_blocks(model, batch, None))
    tx = build_optimizer("adam", OVERFIT_LR)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"))
    state = TrainState.create(model.params(), tx)
    frames, n_labels = batch["signal"].shape[1], float(batch["label_lengths"].sum())
    crossed = per_char = None
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OVERFIT_MAX_STEPS):
        state, m = step(state, batch)
        per_char = float(m["ctc_loss"]) * frames / n_labels
        if crossed is None and per_char < OVERFIT_CROSS:
            crossed = i + 1
        if per_char < OVERFIT_STOP:
            break
    secs = time.perf_counter() - t0
    steps = i + 1
    launches = {k: v for k, v in read_counts().items() if v}
    n_blocks = len(layers)
    want = {"fused_gated_block": n_blocks * steps, "fused_gated_block_bwd": n_blocks * steps,
            "ctc_alpha": steps, "ctc_beta": steps}
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
    log(f"(b) real-read overfit on the card (float32, {n_blocks} + {2 * n_blocks} blocks at "
        f"C={OVERFIT_C}, Adam {OVERFIT_LR}, B={batch['signal'].shape[0]} L={frames}): "
        f"per-char CTC below {OVERFIT_CROSS} at step {crossed}, {steps} steps to "
        f"{per_char:.4f} (< {OVERFIT_STOP}); greedy decode equals the read's bases; "
        f"{secs * 1e3 / steps:.3f} ms a step, {secs:.1f} s (host clock, the per-step loss "
        f"read included); launches {launches}; B4, B5 at C={OVERFIT_C} within phases 1/5's "
        f"tolerances, max_abs_err {f_err:.3e}, {b_err:.3e}")
    return dict(launches=launches, shape=f"B={batch['signal'].shape[0]} L={frames} "
                f"C={OVERFIT_C}", steps=steps)


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
    None on StopIteration, host ms waited)."""
    fetch = Dataset.fetch

    def recorded(ds, stream="train"):
        t0 = time.perf_counter()
        try:
            batch = fetch(ds, stream)
        except StopIteration:
            rec.append((stream, None, (time.perf_counter() - t0) * 1e3))
            raise
        rec.append((stream, batch, (time.perf_counter() - t0) * 1e3))
        return batch

    return mock.patch.object(Dataset, "fetch", recorded)


def ecoli_train_runs(cfg, run_dir, dev):
    """(c) cli.train_with_result on the config twice on one run directory:
    20 steps, then resumed at 20 to 40. K=5 steps a call on (5, 8, 1216)
    int32 levels, B4-bf16 15 times a train step and a validation forward
    (4 fixed batches a print), B5-bf16 15 times a train step, B1 and B2
    once a step (B1 once a validation forward); no StopIteration before
    max_iters, and no producer thread alive after either run. Returns the
    first run's launches, the runs' loop samples/s and the train fetches'
    waits."""
    t = cfg["training"]
    n_blocks = len(cfg["model"]["base"]["dilations"])
    stacked = ((t["steps_per_call"], t["batch_size"], t["pad_to"]), "int32")
    counts, rates, waits = None, [], []
    to_device = cli.batch_to_device
    for run, (start, end) in enumerate(((0, ECOLI_STEPS), (ECOLI_STEPS, 2 * ECOLI_STEPS)), 1):
        logged = len(read_jsonl(run_dir / "logs" / "metrics.jsonl")) if run > 1 else 0
        fetched, copied = [], []

        def recorded_copy(b, d):
            copied.append((b.signal.shape, str(b.signal.dtype)))
            return to_device(b, d)

        reset_counts()
        t0 = time.perf_counter()
        with recording_fetch(fetched), mock.patch.object(cli, "batch_to_device", recorded_copy):
            result = cli.train_with_result(copy.deepcopy(cfg), dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run_counts = {k: v for k, v in read_counts().items() if v}
        counts = counts or run_counts
        lines = read_jsonl(run_dir / "logs" / "metrics.jsonl")[logged:]
        steps, valid = end - start, len(lines) * t["fixed_valid_batches"]
        want = {"fused_gated_block_bf16": n_blocks * (steps + valid),
                "fused_gated_block_bwd_bf16": n_blocks * steps,
                "ctc_alpha": steps + valid, "ctc_beta": steps}
        train = [(b, ms) for s, b, ms in fetched if s == "train"]
        served = [i for i, (b, _) in enumerate(train) if b is not None]
        early = [i for i, (b, _) in enumerate(train) if b is None and i < steps]
        waits.extend(ms for b, ms in train if b is not None)
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
        rates.append(lines[-1]["samples_per_sec"])
        log(f"(c) train run {run}: steps {start + 1}-{end} in {secs:.1f} s (model build, "
            f"{t['nworkers']} workers' start and the last fetch's 1 s timeout included); "
            f"copies to the card {got_copies}; loop samples_per_s {rates[-1]:.0f} (between "
            f"the prints at steps {end - ECOLI_PRINT} and {end}); losses "
            + ", ".join(f"step {l['step']} train {l['train_loss']:.4f} valid "
                        f"{l['valid_loss']:.4f}" for l in lines)
            + f"; launches {run_counts}; checkpoints {ckpts}; StopIterations before max_iters "
            f"0; producer threads alive after the run 0")
    return counts, rates, waits


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
    return onehot


def ecoli_evaluate(cfg, run_dir, dev):
    """(e) The evaluate command on (c)'s run, decoder beam W=7, 4 held-out
    batches (captured as evaluate draws them: 4 producers do not fix their
    order): B6 once a batch; the printed loss equal to the eval step on
    those batches, the identity to that of beam_search_ref's decode of the
    same one-hot forward, to which B6 is held row for row; the loader's
    threads closed. Returns the launches and B6's ms at this shape."""
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
    batches = [b for _, b, _ in drawn if b is not None]
    ds, model, state, _, eval_fn, _ = cli.build_from_config(copy.deepcopy(cfg), dev)
    ds.close()
    state = restore_checkpoint(str(run_dir / "ckpts"), state)
    model.load_params(state.params)
    losses, ids, err, b6_ms = [], [], 0.0, None
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
        if b6_ms is None:
            b6_ms = cuda_ms(lambda: beam_search_kernel(lp, lengths, **kw), 5)
            shape = f"B={lp.shape[0]} T={lp.shape[1]} C={lp.shape[2]} W={BEAM_WIDTH}"
    n_blocks = len(cfg["model"]["base"]["dilations"])
    n = ECOLI_EVAL_BATCHES
    want_launches = {"fused_gated_block_bf16": n_blocks * n, "fused_gated_block": n_blocks * n,
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
        f"{shape}: every live row equal to beam_search_ref's (max score error {err:.3e}), "
        f"{b6_ms:.4f} ms; producer threads alive after it 0")
    return launches, shape


def ecoli_times(cfg, dev, path, onehot, rates, waits, card):
    """(f) The worker's host ms a batch, a levels batch's copy against its
    one-hot's, the K=5 call, the validation forward, the loop, the
    producers, the peak memory."""
    t = cfg["training"]
    f = sys.modules["h5py"].File(str(path), "r")
    try:
        rng = np.random.default_rng(SEED)
        keys = sorted(f.keys())
        worker_ms, _ = host_ms(lambda: ecoli_worker_fn(
            f, keys, rng, batch_size=t["batch_size"],
            sample_lengths=(t["min_sample_length"], t["max_sample_length"]), num_levels=LEVELS,
            pad_to=t["pad_to"], labels_pad_to=t["labels_pad_to"], device_onehot=True), 20)
    finally:
        f.close()
    ds, model, state, (_, _, _, multi, K), eval_fn, _ = cli.build_from_config(
        copy.deepcopy(cfg), dev)
    try:
        bs = [ds.fetch("train") for _ in range(K)]
    finally:
        ds.close()
    levels_ms, batch = host_ms(lambda: batch_to_device(bs[0], dev), 10)
    onehot_ms, _ = host_ms(lambda: batch_to_device(onehot, dev), 10)
    stacked = batch_to_device(Batch(*(np.stack([getattr(b, k) for b in bs]) for k in FIELDS)),
                              dev)
    box = [state]

    def call():
        box[0], m = multi(box[0], stacked)
        return m

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call_ms, _ = host_ms(call, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_ms, _ = host_ms(lambda: eval_fn(box[0].params, batch), 10)
    n = K * t["batch_size"] * t["pad_to"]
    log(f"(f) ecoli_worker_fn {worker_ms:.3f} ms a batch (host; B={t['batch_size']}, "
        f"{t['min_sample_length']}-{t['max_sample_length']} events, padded to {t['pad_to']}); "
        f"copy to the card {levels_ms:.3f} ms a levels batch ({bs[0].signal.nbytes / 1e3:.1f} "
        f"KB) against {onehot_ms:.3f} ms its one-hot ({onehot.signal.nbytes / 1e6:.2f} MB); "
        f"the K={K} call {call_ms:.3f} ms ({n / call_ms * 1e3:.0f} samples/s; host clock, "
        f"synchronised, mean of 3 after a warm call); validation forward {eval_ms:.3f} ms; the "
        f"loop {rates[0]:.0f} / {rates[1]:.0f} samples/s (runs 1 / 2, between prints); the "
        f"producers kept up: no StopIteration before max_iters, train fetches waited "
        f"{sum(waits):.1f} ms in all over {len(waits)} batches (max {max(waits):.2f}); peak "
        f"memory {peak:.2f} GiB (the K-step calls); card {card}")


def run_hdf5(dev, card):
    """Phase 11: the HDF5 read path. (a) the real-read fixture rebuilt,
    (b) the overfit on it, then on a read set of 8 reads x 4000 events:
    (c) configs/ecoli_hdf5_quality.json through train and a resume, B4/B5-bf16
    held at its 15 blocks, B1/B2 at its length-aware CTC, (d) levels against
    one-hot, (e) evaluate, (f) times."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_hdf5_"))
    try:
        fx = rebuild_fixture(tmp)
        overfit = overfit_realread(dev, fx)
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
            counts, rates, waits = ecoli_train_runs(cfg, run_dir, dev)
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
            onehot = levels_equal_onehot(step, state, b, dev)
            del model, state, step, logits, lp_ext
            ev_launches, b6_shape = ecoli_evaluate(cfg, run_dir, dev)
            ecoli_times(cfg, dev, path, onehot, rates, waits, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return dict(launches={"overfit": overfit["launches"], "train": counts,
                          "evaluate": ev_launches},
                shapes={"overfit": f"real-read overfit {overfit['shape']}",
                        "train": f"ecoli_hdf5_quality B=8 L=1216 T={T} J={J}, a train run "
                                 f"of {ECOLI_STEPS} steps",
                        "evaluate": f"ecoli_hdf5_quality {b6_shape}, an evaluate of "
                                    f"{ECOLI_EVAL_BATCHES} batches"})


# ---- 12. the quality harness: examples/gaussian_eval.py at full width ---------

ROOT = Path(__file__).resolve().parent
HARNESS = "wavenet_speech_tpu_torch.examples.gaussian_eval"
BISECT = "wavenet_speech_tpu_torch.tools.bisect_nonfinite"
# the reference's eval architecture (2048 features, fk 3, 100 non-causal
# blocks of 512 channels, 50 at k=2 and 50 at k=3, out 512, 5 labels),
# Adamax 2e-4, batch_standardize, CTC per logit, float32
QUALITY_WIDTH = ("--scale", "1.0", "--nhid", "512")
QUALITY_STEPS, QUALITY_SAVE, QUALITY_EVAL_BATCHES = 20, 10, 2
QUALITY_BF16_STEPS = 5
# the harness's CTC against the plain CTC on the same logits; the native
# engine's scores (double) against B6's (float32)
QUALITY_CTC_RTOL = NATIVE_SCORE_RTOL = 1e-5
# forensics: where out1.w x 1e30 may first go non-finite (at or after out1;
# tests/test_diagnostics.py)
AFTER_OUT1 = ("out1", "logits", "ctc_per_seq", "loss", "global_norm_sumsq")
SMOKE_PRINTS = (0, 50, 100)


def run_module(module, args, what):
    """``python -m module args`` from the checkout's root, as a user runs
    it (on this card, a process of its own); returns (stdout, seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise AssertionError(f"{what}: python -m {module} exited {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


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
    equal, max_to_keep's directories. Returns D1's result, its checkpoint
    directory and its launches."""
    d1, d2 = tmp / "d1" / "ckpts", tmp / "d2" / "ckpts"
    out = {k: tmp / f"{k}.json" for k in ("d1", "d2_10", "d2", "d2_eval")}
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r1 = gaussian_eval.main(harness_args(d1, out["d1"], QUALITY_STEPS))
    torch.cuda.synchronize()
    secs = {"D1 (20 steps, this process)": time.perf_counter() - t0}
    launches = {k: v for k, v in read_counts().items() if v}
    want = {"ctc_alpha": QUALITY_STEPS + QUALITY_EVAL_BATCHES, "ctc_beta": QUALITY_STEPS,
            "ctc_beam": QUALITY_EVAL_BATCHES}
    if launches != want:
        raise AssertionError(f"(a) D1: launches {launches}, expected {want}")
    _, secs["D2 (10 steps)"] = run_module(
        HARNESS, harness_args(d2, out["d2_10"], QUALITY_SAVE), "(a) D2, 10 steps")
    text, secs["D2 resumed to 20"] = run_module(
        HARNESS, harness_args(d2, out["d2"], QUALITY_STEPS), "(a) D2, resumed")
    text_e, secs["D2 --eval-only"] = run_module(
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
        f"directories {dirs} (max_to_keep 4, final save max_to_keep 2); seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    log(f"(a) result: {json.dumps(r1)}")
    return r1, d1, launches, n, len(a["params"])


def quality_batch_inputs(net, params, batch):
    """The eval forward's logits and what B1 gets from them: the extended
    log-probs (T, B, J) and the skip mask."""
    with torch.no_grad():
        logits = torch.func.functional_call(net, params, (batch_standardize(batch["signal"]),))
    ext, allow = _extend_labels(batch["labels"], 0)
    lp_ext = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
    return logits, lp_ext, torch.where(allow, 0.0, NEG)


def quality_eval_recompute(net, params, r1, card):
    """(b) D1's evaluation recomputed from its step-20 params on the same
    held-out batches: the per-logit CTC on the plain CTC within
    QUALITY_CTC_RTOL; B6's beams row for row equal to the plain beam's; the
    native engine's best paths and times equal to B6's, its scores within
    NATIVE_SCORE_RTOL; the identities from those decodes equal to the
    JSON's. B1/B2 at this shape against their plain versions (phase_ctc),
    B6's and the native engine's times."""
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
        plain_ms, want = host_ms(lambda: beam_finalize(beam_search_ref(lp, full, **kw)))
        live, err = compare_beams(got, want, BEAM_WIDTH)
        b6_err, live_rows = max(b6_err, err), live_rows + live
        host_logits = logits.cpu().numpy()
        nl, nn, ns, nt = ctc_beam_search_native(host_logits, beam_width=BEAM_WIDTH,
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
            b1, b2 = phase_ctc(lp_ext, skip, logits, batch)
            ms = cuda_ms(lambda: beam_search_kernel(lp, full, **kw), 5)
            bound_ms, bound_by = bound_of(*b6_work(lp, full, S))
            b6 = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            native_ms = {}
            for threads in (0, 1):
                native_ms[threads], _ = host_ms(lambda: ctc_beam_search_native(
                    host_logits, beam_width=BEAM_WIDTH, max_label_len=S,
                    num_threads=threads), 3)
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
    log(f"(d) the eval batch ({shape}): B1 {b1['ms']:.4f} ms, B6 {b6['ms']:.4f} ms "
        f"(plain {b6['plain_ms']:.1f} ms, bound {b6['bound_ms']:.6f} ms, {b6['bound_by']}; "
        f"CUDA events); the "
        f"native engine {native_ms[0]:.3f} ms with its default threads, {native_ms[1]:.3f} "
        f"ms on 1 thread (host clock, the log-softmax on the host included); card {card}")
    b6.update(err=b6_err, native_ms=native_ms)
    return dict(b1=b1, b2=b2, b6=b6, shape=shape)


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
    _, secs = run_module(BISECT, ["--dump", path, *QUALITY_WIDTH, "--out", str(out)],
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
    log(f"(c) bisect_nonfinite on D1's params with out1.w x 1e30 ({secs:.1f} s, a process "
        f"of its own): VERDICT {rep['verdict']}; probe == model forward in bf16 and float32")


def quality_step_parts(net, tx, state, batch):
    """(d) The float32 step's forward (CTC included) and backward (CUDA
    events, mean of 3), the skip guard and Adamax's update over the
    parameter tensors (CUDA events), and the card's busy share over 3
    steps (torch.profiler)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fwd = bwd = 0.0
    for _ in range(3):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        ev[0].record()
        logits = torch.func.functional_call(net, leaves,
                                            (batch_standardize(batch["signal"]),))
        Bx, T = logits.shape[:2]
        loss = ctc_loss_per_seq(logits, torch.full((Bx,), T, dtype=torch.int32,
                                                   device=logits.device),
                                batch["labels"], batch["label_lengths"]).sum() / T
        ev[1].record()
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                            materialize_grads=True)
        ev[2].record()
        torch.cuda.synchronize()
        fwd += ev[0].elapsed_time(ev[1]) / 3
        bwd += ev[1].elapsed_time(ev[2]) / 3
    g = state.params
    guard_ms = cuda_ms(lambda: (global_norm_safe(g), all_finite(g)), 3)
    update_ms = cuda_ms(lambda: tx.update(g, state.opt_state, g), 3)
    return fwd, bwd, guard_ms, update_ms


def quality_times(dev, card):
    """(d) The harness's step at full width from its init: float32 (mean of
    5) and bf16 (mean of QUALITY_BF16_STEPS) on CUDA events after a warm
    step, samples/s, peak memory; the float32 step's parts and busy share."""
    from torch.profiler import ProfilerActivity, profile
    args = gaussian_eval.parse_args([*QUALITY_WIDTH])
    net = gaussian_eval.build_model(1.0, nhid=512, device=dev)
    net.reset_parameters(torch.Generator().manual_seed(gaussian_eval.TRAIN_SEED))
    b = gaussian_eval.make_loader(args, gaussian_eval.TRAIN_SEED).fetch()
    batch = batch_to_device(b, dev)
    tx = build_optimizer("adamax", args.lr)
    n = int(np.prod(b.signal.shape[:2]))
    lines = []
    for dtype, reps in ((None, 5), (BF16, QUALITY_BF16_STEPS)):
        step = make_ctc_train_step(net, tx, compute_dtype=dtype, preprocess=batch_standardize)
        box = [TrainState.create({k: v.detach().clone() for k, v in net.state_dict().items()},
                                 tx)]

        def one_step():
            box[0], m = step(box[0], batch)
            return m

        one_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one_step, reps, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lines.append(f"{'bf16' if dtype else 'float32'} {ms:.3f} ms a step (mean of {reps}), "
                     f"{n / ms * 1e3:.0f} samples/s, peak memory {peak:.2f} GiB")
        if dtype is None:
            fwd, bwd, guard_ms, update_ms = quality_step_parts(net, tx, box[0], batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall_ms, _ = host_ms(one_step, 3)
            busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 3 / 1e3
        del box, step
        torch.cuda.empty_cache()
    log(f"(d) the harness's train step (B={b.signal.shape[0]}, L={b.signal.shape[1]}, "
        f"Adamax, TF32 off; CUDA events after a warm step): " + "; ".join(lines)
        + f"; float32 parts: forward {fwd:.3f} ms, backward {bwd:.3f} ms (CUDA events, mean "
        f"of 3), skip guard {guard_ms:.3f} ms, Adamax update {update_ms:.3f} ms "
        f"({len(net.state_dict())} parameter tensors); the card busy {busy_ms:.3f} of "
        f"{wall_ms:.3f} ms a step over 3 steps ({busy_ms / wall_ms:.1%}; torch.profiler); "
        f"card {card}")
    del net


def quality_smoke(tmp, card):
    """(e) The --smoke preset's 150 steps on the card: the per-logit CTC at
    steps 0, 50 and 100 must fall, the result JSON be finite."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = gaussian_eval.main(["--smoke", "--out", str(tmp / "smoke.json")])
    secs = time.perf_counter() - t0
    ctc = ctc_prints(buf.getvalue())
    numbers = [r["avg_per_logit_ctc"], r["ref_convention_per_logit_ctc"],
               r["mean_identity"], *r["identities"]]
    if sorted(ctc) != list(SMOKE_PRINTS) or not ctc[SMOKE_PRINTS[-1]] < ctc[0] \
            or not all(map(math.isfinite, numbers)):
        raise AssertionError(f"(e) --smoke: per-logit CTC {ctc}, result {r}")
    log(f"(e) --smoke (scale 1/64, 10 blocks of 32 channels, batch 4, lr 2e-3, 150 steps) on "
        f"the card in {secs:.1f} s: per-logit CTC " + ", ".join(
            f"step {s} {v:.4f}" for s, v in ctc.items()) + f"; result {json.dumps(r)}; "
        f"card {card}")


def run_quality(dev, card):
    """Phase 12: the quality harness (examples/gaussian_eval.py) at the
    reference's full width: train, resume, evaluate, forensics, timings,
    the --smoke preset. card: nvidia-smi's name and power limit."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_"))
    try:
        t_build = time.perf_counter()
        native_beam.load_library(tmp / "native_build")  # a fresh build, timed
        build_s = time.perf_counter() - t_build
        log(f"phase 12: the native beam library built with g++ in {build_s:.2f} s (a fresh "
            f"directory)")
        # ---- (a) the main path: train, resume, re-evaluate
        r1, d1, launches, n_params, n_tensors = quality_train_runs(tmp)
        net = gaussian_eval.build_model(1.0, nhid=512, device=dev)
        params = {k: v.to(dev) for k, v in torch.load(
            d1 / str(QUALITY_STEPS) / "state.pt", map_location="cpu",
            weights_only=True)["params"].items()}
        # ---- (b) the evaluation against its recomputation
        ev = quality_eval_recompute(net, params, r1, card)
        # ---- (c) forensics on poisoned params
        args = gaussian_eval.parse_args([*QUALITY_WIDTH])
        quality_forensics(params, gaussian_eval.make_loader(
            args, gaussian_eval.TRAIN_SEED).fetch(), tmp)
        del net, params
        torch.cuda.empty_cache()
        # ---- (d) timings
        quality_times(dev, card)
        # ---- (e) the --smoke preset
        quality_smoke(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, shape=ev["shape"], b1=ev["b1"], b2=ev["b2"], b6=ev["b6"],
                params=n_params, tensors=n_tensors, native_build_s=build_s)


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
    with tempfile.TemporaryDirectory() as tmp:
        ptxas = start_ptxas_report(tmp)
        secs = _build.build()
        log(f"built kernels from the checkout: "
            + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
        log_ptxas_report(ptxas)

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
    scale_res_w(model)

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
    with torch.inference_mode():
        phase_padded_block(dev)

    # ---- 5. training: the joint step at full width
    del model, caller, greedy, x, logits, plain_logits, lp
    train = run_training(dev)
    # ---- 6. bf16 training at full width
    bf16 = run_training_bf16(dev)
    # ---- 7. the train entry point
    cli_launches = phase_train_cli(dev)
    # ---- 8. DP and SP over torch.distributed: this slice's main path
    b3 = run_parallel(dev, smi)
    # ---- 9. long-read serving: chunked forwards, B6 on the carried state
    long_read = run_long_read(dev, smi)
    # ---- 10. RawCTCNet training and evaluation: train, evaluate, B1/B2/B6
    gauss = run_gauss_training(dev, smi)
    # ---- 11. the HDF5 read path: the ecoli configs through train and evaluate
    hdf5 = run_hdf5(dev, smi)
    # ---- 12. the quality harness at full width: train, resume, evaluate, bisect
    quality = run_quality(dev, smi)
    check_numerics("after every phase")
    log(f"total {time.perf_counter() - t_start:.1f} s; card (nvidia-smi name, power.limit):")
    log(smi)

    kernels = [
        dict(name="fused_gated_block", route="cuda",
             source="wavenet_speech_tpu_torch/csrc/fused_block.cu",
             replaces="wavenet_speech_tpu/ops/pallas/residual_block.py:58",
             launches=launches["fused_gated_block"], max_abs_err=b4["err"],
             ms=b4["ms"], plain_ms=b4["plain_ms"], bound_ms=b4["bound_ms"],
             bound_by=b4["bound_by"], library_ms=b4["library_ms"],
             long_read_launches=long_read["b4_launches"]),
        dict(name="ctc_beam", route="cuda",
             source="wavenet_speech_tpu_torch/csrc/ctc_beam.cu",
             replaces="wavenet_speech_tpu/ops/pallas/attic/beam.py:62",
             launches=launches["ctc_beam"], max_abs_err=b6["err"],
             ms=b6["ms"], plain_ms=b6["plain_ms"], bound_ms=b6["bound_ms"],
             bound_by=b6["bound_by"], library_ms=None, us_per_frame=b6["us_per_frame"],
             long_read_launches=long_read["b6_launches"]),
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
    for key, name, source, line in (
            ("f", "fused_gated_block_bf16", "fused_block_bf16.cu", 58),
            ("b", "fused_gated_block_bwd_bf16", "fused_block_bwd_bf16.cu", 201)):
        k = bf16[key]
        kernels.append(dict(
            name=name, route="cuda", source=f"wavenet_speech_tpu_torch/csrc/{source}",
            replaces=f"wavenet_speech_tpu/ops/pallas/residual_block.py:{line}",
            launches=cli_launches[name], max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"]))
    kernels.extend(b3)
    for name in {k["name"] for k in kernels}:   # phase 11's launches on each kernel's first line
        k = next(k for k in kernels if k["name"] == name)
        runs = {run: c[name] for run, c in hdf5["launches"].items() if c.get(name)}
        if runs:
            k.update(hdf5_launches=runs, hdf5_shapes={run: hdf5["shapes"][run] for run in runs})
    for key, name, source, replaces in (
            ("b1", "ctc_alpha", "ctc.cu", "ctc.py:83"), ("b2", "ctc_beta", "ctc.cu", "ctc.py:142"),
            ("b6", "ctc_beam", "ctc_beam.cu", "attic/beam.py:62")):
        k = gauss[key]
        kernels.append(dict(
            name=name, shape=f"gauss_quality {k['shape']}", route="cuda",
            source=f"wavenet_speech_tpu_torch/csrc/{source}",
            replaces=f"wavenet_speech_tpu/ops/pallas/{replaces}", launches=k["launches"],
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k.get("library_ms")))
    for name in ("ctc_alpha", "ctc_beta", "ctc_beam"):  # phase 12's on each first line
        next(k for k in kernels if k["name"] == name).update(
            quality_launches=quality["launches"][name], quality_shape=quality["shape"])
    for key, name, source, replaces in (
            ("b1", "ctc_alpha", "ctc.cu", "ctc.py:83"), ("b2", "ctc_beta", "ctc.cu", "ctc.py:142"),
            ("b6", "ctc_beam", "ctc_beam.cu", "attic/beam.py:62")):
        k = quality[key]
        kernels.append(dict(
            name=name, shape=f"quality harness {quality['shape']}", route="cuda",
            source=f"wavenet_speech_tpu_torch/csrc/{source}",
            replaces=f"wavenet_speech_tpu/ops/pallas/{replaces}",
            launches=quality["launches"][name], max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k.get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
