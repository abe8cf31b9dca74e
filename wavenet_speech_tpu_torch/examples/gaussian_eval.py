"""The repository's headline quality experiment on the port
(examples/gaussian_eval.py): RawCTCNet trained on the Gaussian r9.4 5-mer
generator, scored by average per-logit CTC loss and pairwise-alignment
basecall identity.

Reference anchors (RawCTCNet@AvgCTCLoss=0.6 eval notebook): best avg
per-logit CTC 0.5548; basecall identity 49.5%-78.0% over 6 samples; model
nfeats 2048 / 100 blocks, batch 6, upsample 6 random, lengths 80-90,
Adamax lr 2e-4.

Usage:
  python -m wavenet_speech_tpu_torch.examples.gaussian_eval --scale 1.0   # full width
  python -m wavenet_speech_tpu_torch.examples.gaussian_eval --smoke --device cpu

It runs on ``cuda`` unless ``--device`` names another device. On the card
the train step runs the CTC kernels (B1, B2) and the evaluation B1 and the
prefix beam kernel (B6); ``--device cpu`` runs their plain versions.
``--ckpt-dir`` gives periodic full-state checkpoints (the newest 4 kept),
resume from the latest one, and a stall watchdog (``GAUSS_STALL_SECS``,
default 420 s) that re-runs ``python -m`` this module with the same
arguments when the loop makes no progress. Non-finite and spiking steps
leave forensic dumps in ``<ckpt-dir>/../anomalies`` for
``python -m wavenet_speech_tpu_torch.tools.bisect_nonfinite``.

The JAX flags are kept but one: ``--platform`` is ``--device``. ``remat``
is not ported (the port's stack is eager; see models/stack.py), so
``--no-remat`` changes nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from wavenet_speech_tpu_torch.data.gaussian_kmer import RawGaussianModelLoader
from wavenet_speech_tpu_torch.data.prefetch import batch_to_device
from wavenet_speech_tpu_torch.decoding.alignment import batch_identity
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import ctc_beam_search
from wavenet_speech_tpu_torch.decoding.greedy import labels2strings
from wavenet_speech_tpu_torch.models import RawCTCNet
from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_per_seq
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training import TrainState, build_optimizer
from wavenet_speech_tpu_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                                          save_checkpoint,
                                                          wait_for_async_saves)
from wavenet_speech_tpu_torch.training.diagnostics import dump_anomaly
from wavenet_speech_tpu_torch.training.optimizer import _polynomial, _warmup_cosine
from wavenet_speech_tpu_torch.training.trainer import make_ctc_train_step
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.run_logging import MovingAverageMeter

MODULE = "wavenet_speech_tpu_torch.examples.gaussian_eval"
UPSAMPLING = 6
TRAIN_SEED, EVAL_SEED = 0, 777


class StallWatchdog:
    """Re-runs ``python -m MODULE argv`` (which resumes from the latest
    checkpoint) when ``tick`` has not been called for stall_seconds
    (GAUSS_STALL_SECS, default 420: the first steps of the full-width model
    take a while). ``stop`` ends the thread, so a program that called
    ``main`` goes on unwatched."""

    def __init__(self, argv, stall_seconds: Optional[float] = None,
                 poll_seconds: float = 10.0):
        self.argv = list(argv)
        self.stall_seconds = (float(os.environ.get("GAUSS_STALL_SECS", 420.0))
                              if stall_seconds is None else stall_seconds)
        self.poll_seconds = poll_seconds
        self._last = time.time()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def tick(self) -> None:
        self._last = time.time()

    def stop(self) -> None:
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.poll_seconds):
            if time.time() - self._last > self.stall_seconds:
                print("[gaussian_eval] training loop stalled; re-exec for resume",
                      file=sys.stderr, flush=True)
                os.execv(sys.executable, [sys.executable, "-m", MODULE, *self.argv])


def build_model(scale: float, nhid: int = 512, device=None) -> RawCTCNet:
    """The reference eval checkpoint's architecture (0.6-eval notebook cell
    8): featurizer width nfeats=2048, residual stack width nhid=512 (the
    stack is NOT featurizer-wide), 10 x [1,2,4,8,16] dilation cycles for
    each kwidth in {2,3} = 100 blocks, out_dim 512. `scale` scales the
    featurizer width; `nhid` is the stack width (512 = reference).
    Parameters uninitialised: call ``reset_parameters``."""
    nfeats = max(int(2048 * scale), 16)
    nhid = max(int(nhid * min(scale * 4, 1.0)), 16)
    reps = max(int(10 * min(scale * 8, 1.0)), 1)
    dils = (1, 2, 4, 8, 16) * reps
    layers = tuple((nhid, nhid, 2, d) for d in dils) + tuple((nhid, nhid, 3, d) for d in dils)
    return RawCTCNet(nfeats, 3, 5, layers, nhid, positions=False, softmax=False,
                     causal=False, device=device)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    ap.add_argument("--scale", type=float, default=0.125)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=6)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--beam-width", type=int, default=7)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="tiny fast run (CI/CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume dir (enables stall watchdog)")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--async-ckpt", action="store_true",
                    help="overlap checkpoint writes with training (a writer thread)")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate the latest checkpoint")
    ap.add_argument("--no-remat", action="store_true",
                    help="accepted for the JAX harness's command lines; changes nothing "
                         "(remat is not ported)")
    ap.add_argument("--cosine", action="store_true",
                    help="warmup + cosine-decay LR schedule over --steps "
                         "(reference protocol is constant LR)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear warmup steps, then constant LR (keeps the "
                         "run length open-ended, unlike --cosine)")
    ap.add_argument("--nhid", type=int, default=512,
                    help="residual-stack width (reference: 512)")
    ap.add_argument("--max-grad-norm", type=float, default=None,
                    help="global-norm GRADIENT clipping (warning: raw grad "
                         "norms here are O(1e13); small thresholds destroy "
                         "adamax updates — prefer --max-update-norm)")
    ap.add_argument("--max-update-norm", type=float, default=None,
                    help="global-norm clipping of the post-optimizer UPDATE "
                         "(typical update norm ~3; e.g. 30 bounds "
                         "divergence spikes without touching normal steps)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale, args.batch_size, args.lr = 1 / 64, 4, 2e-3
        if args.steps == 2000:  # only override the untouched default
            args.steps = 150
    return args


def learning_rate(args):
    """--cosine: optax.warmup_cosine_decay_schedule(0, lr, min(500,
    steps // 10), steps, lr * 0.05); --warmup N: optax.linear_schedule(0,
    lr, N); else the constant lr."""
    if args.cosine:
        return _warmup_cosine(args.lr, min(500, args.steps // 10), args.steps, args.lr * 0.05)
    if args.warmup:
        return _polynomial(0.0, args.lr, args.warmup)
    return args.lr


def make_loader(args, seed: int, pad_to: Optional[int] = None,
                labels_pad_to: Optional[int] = None) -> RawGaussianModelLoader:
    """The train (seed 0) or eval (seed 777) stream: lengths 80-90 bases
    (smoke 15-18), 6 samples a base (random upsampling but at smoke),
    signals padded to (max_len - 9) * 7 samples (smoke 6) and labels to
    max_len - 1."""
    lengths = (80, 90) if not args.smoke else (15, 18)
    if pad_to is None:
        pad_to = (lengths[1] - 1 - 8) * (UPSAMPLING + (0 if args.smoke else 1))
        labels_pad_to = lengths[1] - 1
    return RawGaussianModelLoader(
        max_iters=10 ** 9, num_epochs=10 ** 6, epoch_size=1000,
        batch_size=args.batch_size, upsampling=UPSAMPLING,
        random_upsample=not args.smoke, lengths=lengths, seed=seed,
        pad_to=pad_to, labels_pad_to=labels_pad_to)


def evaluate(net, params, args, loader, dev, tick=lambda: None) -> dict:
    """Per-logit CTC and basecall identity of params on args.eval_batches
    held-out batches (seed 777, the train stream's padded shapes), in
    float32; the result JSON of the JAX harness."""
    eval_loader = make_loader(args, EVAL_SEED, loader.pad_to, loader.labels_pad_to)
    ctc_vals, idents = [], []
    for _ in range(args.eval_batches):
        tick()
        batch = eval_loader.fetch()
        dev_b = batch_to_device(batch, dev)
        with torch.no_grad():
            logits = functional_call(net, params, (batch_standardize(dev_b["signal"]),))
            B, T = logits.shape[:2]
            per_seq = ctc_loss_per_seq(logits, torch.full((B,), T, dtype=torch.int32,
                                                          device=dev),
                                       dev_b["labels"], dev_b["label_lengths"])
            ctc_vals.append(float(per_seq.sum()) / T)
            prefixes, plens, _ = ctc_beam_search(
                logits, beam_width=args.beam_width,
                max_label_len=int(batch.label_lengths.max() * 2))
        prefixes, plens = prefixes.cpu().numpy(), plens.cpu().numpy()
        preds = [prefixes[b, 0, :plens[b, 0]] for b in range(B)]
        truths = [batch.labels[b, :batch.label_lengths[b]] for b in range(B)]
        _, details = batch_identity(preds, truths)
        idents.extend(d[0] for d in details)
        for p, t in list(zip(preds, truths))[:2]:
            print("  pred:", labels2strings([p])[0])
            print("  true:", labels2strings([t])[0])
    return {
        "avg_per_logit_ctc": float(np.mean(ctc_vals)),
        # the reference's "per-logit" divides the BATCH-SUMMED warp-ctc loss
        # by T only (eval notebook cell 12), so the metric scales with batch
        # size; this is the number re-expressed at the reference's batch 6
        "ref_convention_per_logit_ctc": float(np.mean(ctc_vals)) * 6.0 / args.batch_size,
        "mean_identity": float(np.mean(idents)),
        "identities": [round(float(x), 3) for x in idents],
        "reference_anchor": {"avg_per_logit_ctc": 0.5548, "batch_size": 6,
                             "identity_range": [0.495, 0.78]},
    }


def main(argv=None, *, params=None) -> dict:
    """Train (unless --eval-only), evaluate, print and return the result
    JSON. params: initial weights {name: tensor} of build_model's network
    (default: its init from seed 0), for a run started from given weights,
    e.g. JAX's carried across by ``bridge.raw_ctcnet_from_jax``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    # armed before the first device touch: the build and a restore can stall too
    dog = StallWatchdog(argv).start() if args.ckpt_dir else None
    try:
        return _run(args, params, dog.tick if dog else (lambda: None))
    finally:
        if dog:
            dog.stop()


def _run(args, params, tick) -> dict:
    dev = resolve_device(args.device)
    loader = make_loader(args, TRAIN_SEED)
    net = build_model(args.scale, nhid=args.nhid, device=dev)
    if params is None:
        net.reset_parameters(torch.Generator().manual_seed(TRAIN_SEED))
    else:
        net.load_state_dict(params)
    tx = build_optimizer("adamax", learning_rate(args), max_grad_norm=args.max_grad_norm,
                         max_update_norm=args.max_update_norm)
    state = TrainState.create({k: v.detach().clone() for k, v in net.state_dict().items()}, tx)
    # the reference normalizes the raw signal through BatchNorm1d(1) (train
    # notebook cell 11) before RawCTCNet: batch statistics, in float32
    step = make_ctc_train_step(net, tx, compute_dtype=torch.bfloat16 if args.bf16 else None,
                               preprocess=batch_standardize)

    start = 0
    if args.ckpt_dir:
        tick()
        if latest_step(args.ckpt_dir) is not None:
            state = restore_checkpoint(args.ckpt_dir, state)
            start = int(state.step)
            print(f"resumed from step {start}", flush=True)
        if args.eval_only:
            args.steps = start
        # the loader is deterministic given (seed, iteration): fast-forward
        # so a resumed run sees fresh data instead of replaying batch 0
        if args.steps > start:
            for _ in range(start):
                loader.fetch()

    def dump_forensics(batch, i, note, loss, gnorm):
        # the exact (batch, params) pair for offline bisection; on a skipped
        # step the guard carried the params through, so the dump reproduces it
        if not args.ckpt_dir:
            return
        try:
            p = dump_anomaly(os.path.join(os.path.dirname(args.ckpt_dir.rstrip("/")),
                                          "anomalies"),
                             batch, state.params, i, note,
                             {"ctc_loss": loss, "grad_norm": gnorm})
            if p:
                print(f"[gaussian_eval] {note} at step {i} (loss {loss:.3g}, gnorm "
                      f"{gnorm:.3g}); forensics -> {p}", file=sys.stderr, flush=True)
        except Exception as e:  # forensics must never kill the run
            print(f"[gaussian_eval] forensic dump failed: {e!r}", file=sys.stderr,
                  flush=True)

    meter = MovingAverageMeter(25)
    t0 = time.time()
    skip_streak = 0
    for i in range(start, args.steps):
        tick()
        batch = loader.fetch()
        state, metrics = step(state, batch_to_device(batch, dev))
        loss = float(metrics["ctc_loss"])
        if np.isfinite(loss):
            # a finite but huge spike precedes the divergences of long runs:
            # dumped too (the params are post-step, the note says so)
            if meter.values and loss > max(25.0 * meter.value, 100.0):
                dump_forensics(batch, i, "spike", loss, float(metrics["grad_norm"]))
            meter.add(loss)
            skip_streak = 0
        else:
            # the step skipped the update, so the params stay finite; a long
            # streak means every batch gives a non-finite loss: abort, for a
            # restart from the last checkpoint
            skip_streak += 1
            if skip_streak == 1:
                dump_forensics(batch, i, "nonfinite", loss, float(metrics["grad_norm"]))
            if skip_streak in (1, 10, 50) or skip_streak % 100 == 0:
                print(f"[gaussian_eval] non-finite loss at step {i}; update skipped "
                      f"(streak {skip_streak})", file=sys.stderr, flush=True)
            if skip_streak >= 200:
                print("[gaussian_eval] 200 consecutive non-finite losses; aborting for "
                      "restart from the last checkpoint", file=sys.stderr, flush=True)
                sys.exit(3)
        if i % 50 == 0:
            print(f"step {i}: per-logit CTC {meter.value:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.save_every == 0:
            # never checkpoint a window that held a non-finite loss: with the
            # rotation it would push out the recoverable history
            if not np.isfinite(meter.value) or skip_streak > 0:
                print(f"[gaussian_eval] skipping checkpoint at step {i + 1} (non-finite "
                      "loss in window)", file=sys.stderr, flush=True)
            else:
                save_checkpoint(args.ckpt_dir, state, step=i + 1, max_to_keep=4,
                                async_save=args.async_ckpt)
    if args.ckpt_dir and args.steps > start:
        if args.async_ckpt:
            wait_for_async_saves(args.ckpt_dir)
        save_checkpoint(args.ckpt_dir, state, step=args.steps, max_to_keep=2)
    tick()

    result = evaluate(net, state.params, args, loader, dev, tick)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
