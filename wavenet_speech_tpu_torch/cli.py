"""Config-driven trainer, evaluator and basecaller (wavenet_speech_tpu/
cli.py):

    python -m wavenet_speech_tpu_torch.cli train cfg.json [--device cpu]
    python -m wavenet_speech_tpu_torch.cli evaluate cfg.json [--device cpu]
    python -m wavenet_speech_tpu_torch.cli basecall cfg.json --signals sig.npy
        [--out calls.fasta] [--long] [--device cpu]

Both model types train: wavenet-ctc on the joint loss by default, and
raw-ctcnet (BatchNorm1d + RawCTCNet) on the CTC loss, keeping BatchNorm's
running statistics. Every datatype of the JAX CLI is read: the generated
ones and ``hdf5`` (real reads, through producer threads; with
``device_onehot`` its batches are (B, L) int32 levels, one-hot on the
card).

The training loop follows the JAX CLI's: fixed or fresh validation batches
re-scored at every print, a moving-average train loss, samples/s, early stop
on the validation loss, periodic checkpoints (optionally written on a
thread), resume from the latest checkpoint of the run directory, and a save
on exit. ``evaluate`` restores the run's checkpoint and prints the held-out
loss and the basecall identity over ``eval_batches`` validation batches.
``basecall`` restores the run's latest checkpoint and writes FASTA;
reads above 65,536 samples (or all reads, with ``--long``) go through the
chunked forwards and the streaming beam. The commands run on ``cuda``
unless ``--device`` names another device (``--device cpu`` runs the
kernels' plain versions).

``basecall`` hands the Basecaller the JAX CLI's wrapper (cli.py:413-420),
which exposes the forward alone: the long path stitches its chunks with
margin 0 and no featurizer extension, as the JAX CLI does, so the FASTA is
the JAX CLI's. Those stitched logits differ from the monolithic forward
beside every interior chunk boundary and lack RawCTCNet's last fk - 1
frames (a fault of the reference the port keeps). The API keeps the
model's margin: ``Basecaller(model)`` given the ``facade.Model`` stitches
logits equal to the monolithic forward's. Where ``basecall`` differs from
the JAX CLI: a pooled wavenet-ctc head cannot be chunked (the grid counts
samples) and is refused up front, where the JAX package fails its
stitching check.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from wavenet_speech_tpu_torch.data.common import Batch, MuLawQuantizer, one_hot_lc
from wavenet_speech_tpu_torch.data.prefetch import FIELDS, batch_to_device
from wavenet_speech_tpu_torch.decoding.alignment import batch_identity
from wavenet_speech_tpu_torch.decoding.greedy import labels2strings
from wavenet_speech_tpu_torch.facade import Dataset, Decoder, Model
from wavenet_speech_tpu_torch.inference import Basecaller, output_extension
from wavenet_speech_tpu_torch.training import (JointLoss, TrainState, build_optimizer,
                                               make_eval_step, make_joint_train_step,
                                               make_lr_schedule)
from wavenet_speech_tpu_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                                          save_checkpoint,
                                                          wait_for_async_saves)
from wavenet_speech_tpu_torch.utils.config import config_to_json, json_to_config, training_cfg
from wavenet_speech_tpu_torch.utils.run_logging import Logger, MovingAverageMeter, Throughput

# --- optional stall watchdog ---------------------------------------------------
# With WAVENET_CLI_STALL_SECS set, a ``train`` command whose loop makes no
# progress for that long re-executes itself (``python -m`` this module, the
# same arguments) and so resumes from its latest checkpoint. Only ``main``
# arms it: a program that calls ``train`` has arguments of its own.
_progress = {"t": time.time(), "armed": False}


def _tick():
    _progress["t"] = time.time()


def _stall_watchdog(stall_seconds: float, poll_seconds: float = 10.0):
    while True:
        time.sleep(poll_seconds)
        if _progress["armed"] and time.time() - _progress["t"] > stall_seconds:
            print("[cli] training loop stalled; re-exec for checkpoint resume",
                  file=sys.stderr, flush=True)
            os.execv(sys.executable, [sys.executable, "-m", "wavenet_speech_tpu_torch.cli",
                                      *sys.argv[1:]])


def _arm_watchdog():
    secs = os.environ.get("WAVENET_CLI_STALL_SECS")
    if secs:
        threading.Thread(target=_stall_watchdog, args=(float(secs),),
                         daemon=True).start()
        _tick()
        _progress["armed"] = True


def build_dataset(cfg) -> Dataset:
    """The config's training and validation streams (cli.py:79-91): every
    run of a config starts them from its seed."""
    t = training_cfg(cfg)
    datatype = t.get("datatype", "pore" if t["training_data"] is None else "hdf5")
    return Dataset(
        datatype, dataset=t["training_data"],
        max_iters=t["max_iters"], num_epochs=t["num_epochs"],
        epoch_size=t["epoch_size"], batch_size=t["batch_size"],
        num_levels=cfg.get("model", {}).get("base", {}).get("signal_dim", 256),
        min_length=t["min_sample_length"], max_length=t["max_sample_length"],
        nworkers=t["nworkers"], seed=t.get("seed"), upsampling=t.get("upsampling", 4),
        sample_noise=t.get("sample_noise", 2.0),
        pad_to=t.get("pad_to"), labels_pad_to=t.get("labels_pad_to"),
        device_onehot=bool(t.get("device_onehot", False)))


def build_from_config(cfg, device=None):
    """(dataset, model, state, (step, xe_step, xe_iters, multi_step, K),
    eval_step, training block) of a config, as the JAX CLI builds them
    (cli.py:64-142). The model is on ``device`` (default ``cuda``)."""
    t = training_cfg(cfg)
    dataset = build_dataset(cfg)
    model_type = cfg.get("model", {}).get("type", "wavenet-ctc")
    model = Model(model_type, cfg, device=device).init(t.get("seed") or 0)

    opt = t["optim"]
    tx = build_optimizer(opt["type"], make_lr_schedule(opt),
                         weight_decay=opt.get("wd") or None,
                         max_grad_norm=opt.get("max_grad_norm"),
                         max_update_norm=opt.get("max_update_norm"))
    state = TrainState.create(model.params(), tx)

    loss_choice = t.get("loss", "joint" if model_type == "wavenet-ctc" else "ctc")
    loss = JointLoss(loss_choice)
    compute_dtype = None
    if str(t.get("compute_dtype", "")).lower() in ("bf16", "bfloat16"):
        compute_dtype = torch.bfloat16
    # signal lengths -> logit lengths: L // pool, or RawCTCNet's L + fk - 1
    logit_length_fn = model.output_length if t.get("length_aware_ctc") else None
    kw = dict(compute_dtype=compute_dtype, logit_length_fn=logit_length_fn)
    step = make_joint_train_step(model.model_base, model.model_ctc, tx, loss, **kw)
    # steps_per_call > 1: K stacked batches a call (trainer steps_per_call)
    K = int(t.get("steps_per_call", 1) or 1)
    multi_step = (make_joint_train_step(model.model_base, model.model_ctc, tx, loss,
                                        steps_per_call=K, **kw) if K > 1 else None)
    eval_step = make_eval_step(model.eval_base(), model.model_ctc, loss, **kw)
    # optional XE-only pretraining phase (the JAX CLI's two-phase training)
    xe_iters = int(t.get("xe_pretrain_iters", 0) or 0)
    xe_step = None
    if xe_iters > 0 and loss_choice == "joint":
        xe_step = make_joint_train_step(model.model_base, model.model_ctc, tx,
                                        JointLoss("joint", ctc_weight=0.0), **kw)
    return dataset, model, state, (step, xe_step, xe_iters, multi_step, K), eval_step, t


def train(cfg, device=None) -> int:
    train_with_result(cfg, device)
    return 0


def train_with_result(cfg, device=None) -> dict:
    """Run the training loop (cli.py:150-301) and return {"vloss": best
    validation loss (the train moving average when no validation number
    came), "train_loss", "steps"}. A validation stream that runs dry
    (StopIteration) leaves fewer fixed batches, or a print's validation
    loss nan, as in the JAX CLI. The dataset is closed on exit, after the
    final save."""
    dataset, model, state, (step_fn, xe_step_fn, xe_iters, multi_fn, K), \
        eval_fn, t = build_from_config(cfg, device)
    dev = model.device
    logger = Logger(t["save_dir"])
    config_to_json(cfg, os.path.join(t["save_dir"], "config.json"))

    if t.get("restore"):
        state = restore_checkpoint(t["restore"], state)
        logger.message(f"restored checkpoint from {t['restore']} @ step {int(state.step)}")
    elif latest_step(logger.ckpt_dir) is not None:
        state = restore_checkpoint(logger.ckpt_dir, state)
        logger.message(f"resumed from {logger.ckpt_dir} @ step {int(state.step)}")

    # fixed validation batches, drawn once and re-scored at every print
    fixed_valid = []
    for _ in range(int(t.get("fixed_valid_batches", 0) or 0)):
        try:
            fixed_valid.append(batch_to_device(dataset.fetch("valid"), dev))
        except StopIteration:
            break

    meter = MovingAverageMeter(5)
    tput = Throughput()
    best_vloss = float("inf")
    stop_threshold = t.get("early_stop_vloss")
    step_idx = int(state.step)
    samples_acc = 0
    try:
        while True:
            _tick()
            prev_idx = step_idx
            # K steps a call once past the XE-pretrain phase
            use_multi = multi_fn is not None and (xe_step_fn is None or step_idx >= xe_iters)
            batches = []
            try:
                while len(batches) < (K if use_multi else 1):
                    batches.append(dataset.fetch("train"))
            except StopIteration:
                if not batches:
                    break
            if use_multi and len(batches) == K:
                stacked = Batch(*(np.stack([getattr(b, f) for b in batches])
                                  for f in FIELDS))
                state, metrics = multi_fn(state, batch_to_device(stacked, dev))
                metrics = {k: v[-1] for k, v in metrics.items()}
                step_idx += K
            else:  # single steps (K=1, the XE phase, or a ragged epoch tail)
                for b in batches:
                    step_idx += 1
                    fn = (xe_step_fn if xe_step_fn is not None and step_idx <= xe_iters
                          else step_fn)
                    state, metrics = fn(state, batch_to_device(b, dev))
            samples_acc += sum(int(np.prod(b.signal.shape[:2])) for b in batches)

            if step_idx // t["print_every"] > prev_idx // t["print_every"]:
                # the loss is read back (a sync) only here
                meter.add(float(metrics["total_loss"]))
                tput.tick(samples_acc)
                samples_acc = 0
                vloss = float("nan")
                if fixed_valid:
                    vloss = float(np.mean([float(eval_fn(state.params, vb)["total_loss"])
                                           for vb in fixed_valid]))
                else:
                    try:
                        vbatch = dataset.fetch("valid")
                        vloss = float(eval_fn(state.params, batch_to_device(
                            vbatch, dev))["total_loss"])
                    except StopIteration:
                        pass
                logger.log("loss", step_idx, meter.value, vloss)
                logger.metrics(step_idx, train_loss=meter.value, valid_loss=vloss,
                               ctc_loss=float(metrics["ctc_loss"]),
                               samples_per_sec=tput.samples_per_sec)
                print(f"step {step_idx}: loss {meter.value:.4f} (valid {vloss:.4f}) "
                      f"[{(tput.samples_per_sec or 0):.0f} samples/s]", flush=True)
                if not np.isnan(vloss) and vloss < best_vloss:
                    best_vloss = vloss
                stop_crit = vloss if not np.isnan(vloss) else meter.value
                if stop_threshold is not None and stop_crit < stop_threshold:
                    logger.message(f"early stop at step {step_idx}: "
                                   f"loss {stop_crit:.4f} < {stop_threshold}")
                    break
            if step_idx // t["save_every"] > prev_idx // t["save_every"]:
                save_checkpoint(logger.ckpt_dir, state,
                                async_save=bool(t.get("async_checkpoint")))
                logger.message(f"checkpoint @ step {step_idx}")
    except KeyboardInterrupt:
        logger.message("interrupted; saving")
    finally:
        # save on exit: the periodic save's step is not written twice
        wait_for_async_saves(logger.ckpt_dir)
        save_checkpoint(logger.ckpt_dir, state)
        logger.message(f"final checkpoint @ step {step_idx}")
        dataset.close()
        logger.close()
    return {"vloss": best_vloss if np.isfinite(best_vloss) else meter.value,
            "train_loss": meter.value, "steps": step_idx}


def evaluate(cfg, device=None) -> int:
    """Score the run's checkpoint (``restore``, else the latest under
    ``<save_dir>/ckpts/``) on ``eval_batches`` held-out batches: the eval
    step's loss and the basecall identity of the ``decoder`` ("argmax" or
    "beam", ``beam_width``) against the labels, padded frames excluded
    (cli.py:304-363). A (B, L) levels batch (``device_onehot``) is one-hot
    to the model's signal_dim on the device before the forward, as the
    JAX CLI's ``_predict`` does. Prints the JAX CLI's line, then closes the
    dataset."""
    dataset, model, state, _, eval_fn, t = build_from_config(cfg, device)
    try:
        ckpt = t.get("restore") or f"{t['save_dir'].rstrip('/')}/ckpts/"
        state = restore_checkpoint(ckpt, state)
        model.load_params(state.params)
        decoder = Decoder(t.get("decoder", "argmax"), beam_width=t.get("beam_width", 7))
        signal_dim = cfg.get("model", {}).get("base", {}).get("signal_dim", 256)
        losses, identities = [], []
        for i in range(t.get("eval_batches", 10)):
            try:
                batch = dataset.fetch("valid")
            except StopIteration:
                break
            dev = batch_to_device(batch, model.device)
            losses.append(float(eval_fn(state.params, dev)["total_loss"]))
            signal = dev["signal"]
            if signal.dim() == 2:  # levels: one-hot on the device
                signal = torch.nn.functional.one_hot(signal.long(), signal_dim).float()
            with torch.no_grad():
                logits = model(signal)
            _, decoded = decoder.decode(logits,
                                        lengths=model.output_length(batch.signal_lengths))
            targets = labels2strings([batch.labels[b, :batch.label_lengths[b]]
                                      for b in range(batch.labels.shape[0])])
            identities.append(batch_identity([list(d) for d in decoded], targets)[0])
            if t.get("print_samples") and i == 0:
                for d, tg in list(zip(decoded, targets))[:4]:
                    print(f"  pred: {d}\n  true: {tg}")
        print(f"eval loss over {len(losses)} batches: "
              f"{np.mean(losses) if losses else float('nan'):.4f} | basecall identity: "
              f"{np.mean(identities) if identities else float('nan'):.3f}", flush=True)
    finally:
        dataset.close()
    return 0


LONG_READ_SAMPLES = 65536  # reads longer than this take the long path


def load_signals(path: str, cfg, model_type: str) -> np.ndarray:
    """The ``signal`` array of an NPY/NPZ file as (B, L, C) float32, in the
    JAX CLI's three forms (cli.py:395-411): (B, L) integer levels one-hot
    to the model's signal_dim; (B, L) raw floats into a wavenet-ctc model
    mu-law quantized and one-hot, as its training data is; other (B, L)
    raw floats as (B, L, 1); (B, L, C) as it is."""
    data = np.load(path)
    sig = data["signal"] if hasattr(data, "files") else data
    C = cfg.get("model", {}).get("base", {}).get("signal_dim", 256)
    if sig.ndim == 2 and np.issubdtype(sig.dtype, np.integer):
        return np.eye(C, dtype=np.float32)[sig]
    if sig.ndim == 2 and model_type == "wavenet-ctc":
        q = MuLawQuantizer(C)
        return np.stack([one_hot_lc(q(s), C) for s in sig.astype(np.float64)])
    if sig.ndim == 2:
        return sig.astype(np.float32)[..., None]
    return sig.astype(np.float32)


class ForwardOnly:
    """The JAX CLI's ``_Pipe`` (cli.py:413-420): the model's forward and
    device, without its ``layers``, ``feature_kwidth`` or
    ``output_length``, so the chunk grid stitches with margin 0 and no
    featurizer extension."""

    def __init__(self, model):
        self._model, self.device = model, model.device

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        return self._model(signal)


def basecall(cfg, signals_path: str, out_path: Optional[str] = None,
             long_reads: bool = False, device=None) -> int:
    """Basecall the signals of an NPY/NPZ file with the run's latest
    checkpoint and write FASTA (``>read_i score=...`` lines) to out_path or
    stdout (cli.py:366-442). Reads above LONG_READ_SAMPLES samples, or all
    with long_reads, go through ``Basecaller.basecall_long_batch`` on the
    model wrapped in ``ForwardOnly``, as the JAX CLI's long path runs."""
    t = training_cfg(cfg)
    model_type = cfg.get("model", {}).get("type", "wavenet-ctc")
    model = Model(model_type, cfg, device=device).init(t.get("seed") or 0)
    opt = t["optim"]
    tx = build_optimizer(opt["type"], opt["learning_rate"],
                         weight_decay=opt.get("wd") or None,
                         max_grad_norm=opt.get("max_grad_norm"))
    ckpt = t.get("restore") or f"{t['save_dir'].rstrip('/')}/ckpts/"
    state = restore_checkpoint(ckpt, TrainState.create(model.params(), tx))
    model.load_params(state.params)

    sig = load_signals(signals_path, cfg, model_type)
    caller = Basecaller(ForwardOnly(model), beam_width=t.get("beam_width", 7),
                        cutoff_top_n=t.get("cutoff_top_n"),
                        logit_length_fn=model.output_length, device=model.device)
    if long_reads or sig.shape[1] > LONG_READ_SAMPLES:
        output_extension(model, LONG_READ_SAMPLES)  # a pooled head is refused here
        seqs, scores = caller.basecall_long_batch(sig)
        if caller.saturated_chunks:
            print(f"[basecall] streaming beam window saturated in {caller.saturated_chunks} "
                  f"(chunk, read) pairs: those reads are length-capped", file=sys.stderr)
    else:
        seqs, scores = caller(sig)
    text = "".join(f">read_{i} score={sc:.3f}\n{s}\n"
                   for i, (s, sc) in enumerate(zip(seqs, scores)))
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
    else:
        print(text, end="")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wavenet_speech_tpu_torch.cli",
        description="WaveNet-CTC trainer, evaluator and basecaller, PyTorch/CUDA port")
    ap.add_argument("command", choices=["train", "evaluate", "basecall"])
    ap.add_argument("config", help="path to JSON config")
    ap.add_argument("--signals", default=None, help="basecall: NPY/NPZ file of signals")
    ap.add_argument("--out", default=None, help="basecall: output FASTA path (default stdout)")
    ap.add_argument("--long", action="store_true",
                    help="basecall: force the long-read path (chunked forwards + "
                         f"streaming beam); automatic above {LONG_READ_SAMPLES} samples")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = json_to_config(args.config)
    if args.command == "basecall":
        if not args.signals:
            ap.error("basecall needs --signals")
        return basecall(cfg, args.signals, args.out, args.long, args.device)
    if args.command == "evaluate":
        return evaluate(cfg, args.device)
    _arm_watchdog()
    return train(cfg, args.device)


if __name__ == "__main__":
    sys.exit(main())
