"""Pretraining entry points (wavenet_speech_tpu/training/pretrain.py): the
reference's pretrain_tnt.py (RawCTCNet on RawSignalGenerator; the
'PosEnc' encoder alone and the 'EncDec' encoder + ByteNetDecoder) and
pretrain_rnn.py (encoder + RNNByteNetDecoder), with the reference's
batch-format helpers.

The reference's torchnet loop with Visdom meters is one train step
(``make_ctc_train_step``: B1 and B2 on the card) and a
MovingAverageMeter. Architectures and hyperparameters follow
pretrain_tnt.py:92-127, scaled by ``scale`` (tests run tiny versions).
The builders take JAX's ``remat`` and ignore it: the port has no remat
(``models/stack.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wavenet_speech_tpu_torch.data.prefetch import batch_to_device
from wavenet_speech_tpu_torch.models.bytenet_decoder import ByteNetDecoder
from wavenet_speech_tpu_torch.models.raw_ctcnet import RawCTCNet
from wavenet_speech_tpu_torch.models.rnn_decoder import RNNByteNetDecoder
from wavenet_speech_tpu_torch.training.optimizer import build_optimizer
from wavenet_speech_tpu_torch.training.trainer import TrainState, make_ctc_train_step
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.run_logging import MovingAverageMeter

INIT_SEED = 0   # JAX inits pretrain_ctc's encoder from PRNGKey(0)


def to_concat(labels_batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(B, S) padded -> the labels concatenated (reference
    pretrain_tnt.py:37-43)."""
    return np.concatenate(
        [labels_batch[k, : int(lengths[k])] for k in range(len(labels_batch))]
    ) if len(labels_batch) else np.zeros((0,), labels_batch.dtype)


def to_stack(labels_concat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The labels concatenated -> (B, max_len) 0-padded (reference
    pretrain_tnt.py:45-59)."""
    max_length = int(max(lengths)) if len(lengths) else 0
    out = np.zeros((len(lengths), max_length), dtype=labels_concat.dtype)
    cur = 0
    for k, n in enumerate(lengths):
        n = int(n)
        out[k, :n] = labels_concat[cur: cur + n]
        cur += n
    return out


def _width(scale: float):
    """(features, cycles of dilations) at ``scale``."""
    return max(int(512 * scale), 8), (5 if scale >= 1.0 else 1)


def build_posenc_encoder(scale: float = 1.0, remat: bool = True, *, device=None) -> RawCTCNet:
    """'PosEnc' (reference pretrain_tnt.py:115-127): RawCTCNet, 512
    features, k=3 featurizer, 30 blocks (dilations 1..32 x 5, kwidth 3),
    positions, out_dim 1024, 5 labels; on ``device`` (cuda unless given),
    its params not yet initialised."""
    del remat
    F, reps = _width(scale)
    layers = tuple((F, F, 3, d) for d in (1, 2, 4, 8, 16, 32)) * reps
    return RawCTCNet(F, 3, 5, layers, max(int(1024 * scale), 8), input_kernel_size=2,
                     input_dilation=1, positions=True, softmax=False, causal=False,
                     device=resolve_device(device))


def build_encdec(scale: float = 1.0, max_time: int = 40, remat: bool = True, *, device=None):
    """'EncDec' (reference pretrain_tnt.py:92-113): a RawCTCNet encoder (512
    features, 25 blocks; the reference's layer tuples put the dilation in
    the kwidth slot, read here as JAX does, (c, c, k=2, d)) and a
    ByteNetDecoder (7 labels with start and stop, 32 channels, MU blocks).
    Returns (encoder, decoder) on ``device``, not yet initialised."""
    del remat
    dev = resolve_device(device)
    F, reps = _width(scale)
    enc_layers = tuple((F, F, 2, d) for d in (1, 2, 4, 8, 16)) * reps
    encoder = RawCTCNet(F, 3, F, enc_layers, F, input_kernel_size=2, input_dilation=1,
                        positions=False, softmax=False, causal=False, device=dev)
    ch = max(int(32 * scale), 4)
    decoder = ByteNetDecoder(num_labels=7, encoding_dim=F, channels=ch, output_dim=ch,
                             layers=tuple((3, d) for d in (1, 2, 4, 8, 16)), block="mult",
                             pad=0, start=5, stop=6, max_timesteps=max_time, device=dev)
    return encoder, decoder


def build_rnn_decoder_pair(scale: float = 1.0, max_time: int = 100, remat: bool = True, *,
                           device=None):
    """pretrain_rnn.py:102-105: a RawCTCNet encoder (512 features, 25
    blocks of kwidth 3) and an RNNByteNetDecoder (hidden 256, 3 layers).
    Returns (encoder, decoder) on ``device``, not yet initialised."""
    del remat
    dev = resolve_device(device)
    F, reps = _width(scale)
    enc_layers = tuple((F, F, 3, d) for d in (1, 2, 4, 8, 16)) * reps
    encoder = RawCTCNet(F, 3, F, enc_layers, F, softmax=False, causal=False, device=dev)
    H = max(int(256 * scale), 8)
    decoder = RNNByteNetDecoder(num_labels=7, encoding_dim=F, hidden_dim=H, out_dim=H,
                                num_layers=3, pad=0, start=5, stop=6, max_timesteps=max_time,
                                device=dev)
    return encoder, decoder


def _init_params(encoder: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """pretrain_ctc's initial params: the encoder's init from INIT_SEED,
    as its state dict."""
    encoder.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    return {k: v.detach().clone() for k, v in encoder.state_dict().items()}


def pretrain_ctc(encoder, data_iter, num_steps: int, learning_rate: float = 2e-3,
                 optim_type: str = "adamax", log_every: int = 10,
                 compute_dtype=None, callback=None):
    """Encoder-only CTC pretraining (the reference's 'PosEnc' path, Adamax
    2e-3, pretrain_tnt.py:164-170) on the encoder's device. data_iter
    yields ``data.common.Batch``; callback(i, moving average of the last 5
    losses) every log_every steps from step 0.

    Returns (final TrainState, list of per-logit CTC losses)."""
    dev = resolve_device(next(encoder.parameters()).device)
    tx = build_optimizer(optim_type, learning_rate)
    state = TrainState.create(_init_params(encoder), tx)
    step = make_ctc_train_step(encoder, tx, compute_dtype=compute_dtype)
    meter = MovingAverageMeter(5)
    losses = []
    for i, batch in enumerate(data_iter):
        if i >= num_steps:
            break
        state, metrics = step(state, batch_to_device(batch, dev))
        loss = float(metrics["ctc_loss"])
        losses.append(loss)
        meter.add(loss)
        if callback and i % log_every == 0:
            callback(i, meter.value)
    return state, losses
