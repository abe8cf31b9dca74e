"""Facade (wavenet_speech_tpu/facade.py): the base + CTC model pair, the
datatype-dispatching dataset and the logits decoder.

    model = Model("raw-ctcnet", cfg).init(seed=0)         # or .load_jax(tree)
    base_out, logits = model.predict(signal)               # (B, L, C) NLC
    data = Dataset("raw-gauss", batch_size=8, seed=0)
    batch = data.fetch("train")                            # data.Batch, numpy
    scores, strings = Decoder("beam", beam_width=7).decode(logits)

``Model`` runs on ``cuda`` unless ``device`` is given, and raises when no
CUDA device is present and none was given. ``Model("raw-ctcnet")`` is
BatchNorm1d followed by RawCTCNet: the train step normalizes with the
batch's statistics and keeps the running ones through
``BatchNorm1d.update_state``; ``predict`` and every serving path use the
running statistics (``Model.eval_base()``). ``Dataset`` takes every
datatype of the JAX facade but ``raw-hdf5`` (unsupported there too):
``hdf5`` reads real reads through ``data.hdf5.QueueLoader``'s producer
threads, and ``close()`` stops them. ``Decoder``'s beam runs on the card
(B6) or in numpy; the host C++ engine is not ported (ROADMAP A10).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from wavenet_speech_tpu_torch.bridge import params_from_jax
from wavenet_speech_tpu_torch.data.common import Batch
from wavenet_speech_tpu_torch.data.gaussian_kmer import (GaussianModelLoader,
                                                        RawGaussianModelLoader)
from wavenet_speech_tpu_torch.data.hdf5 import QueueLoader
from wavenet_speech_tpu_torch.data.pore_model import DEFAULT_CURRENTS, PoreModelLoader
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import ctc_beam_search
from wavenet_speech_tpu_torch.decoding.greedy import greedy_ctc_decode, labels2strings
from wavenet_speech_tpu_torch.decoding.prefix_beam import beam_search_decode
from wavenet_speech_tpu_torch.models import RawCTCNet, WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.native import ctc_beam_search_native
from wavenet_speech_tpu_torch.training.checkpoint import restore_params, save_params
from wavenet_speech_tpu_torch.training.trainer import param_tree
from wavenet_speech_tpu_torch.utils.config import (base_model_cfg, classifier_cfg,
                                                   raw_ctcnet_cfg)
from wavenet_speech_tpu_torch.utils.device import resolve_device


class BatchNorm1d(nn.Module):
    """Batch normalization over (batch, time) of raw signals, the base model
    of the raw-ctcnet pair (facade.py:36-80; the reference's
    ``nn.BatchNorm1d(1)``). gamma, beta, mean and var are all parameters,
    as they are leaves of the JAX params tree; mean and var get no gradient.

    The module normalizes with the batch's mean and biased variance over
    (B, L), as torch's train mode; the train step then calls
    ``update_state``, which keeps the running mean and unbiased variance as
    torch's momentum EMA. ``eval_form()`` normalizes with the running
    statistics, as torch's ``.eval()``."""

    running_statistics = True  # batch statistics in training: one rank's batch
    EPS = 1e-5
    MOMENTUM = 0.1

    def __init__(self, num_features: int = 1, *, device=None):
        super().__init__()
        self.use_running = False  # eval_form() turns it on in a shallow copy
        for name in ("gamma", "beta", "mean", "var"):
            self.register_parameter(name, nn.Parameter(
                torch.empty((num_features,), device=device)))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for p, v in ((self.gamma, 1.0), (self.beta, 0.0), (self.mean, 0.0),
                         (self.var, 1.0)):
                p.fill_(v)

    def eval_form(self) -> "BatchNorm1d":
        """This module in its eval form, sharing its parameters (JAX's
        ``dataclasses.replace(bn, use_running=True)``)."""
        view = copy.copy(self)
        view.use_running = True
        return view

    def forward(self, x):
        if self.use_running:
            mean, var = self.mean, self.var
        else:
            mean = x.mean(dim=(0, 1))
            var = x.var(dim=(0, 1), unbiased=False)
        return self.gamma * (x - mean) * torch.rsqrt(var + self.EPS) + self.beta

    def update_state(self, old_params, new_params, *inputs):
        """new_params with mean and var replaced by the EMA
        (1 - m) * old + m * batch, from old_params' running statistics and
        the batch's mean and unbiased variance over (B, L) of inputs[0]."""
        x = inputs[0].detach()
        n = x.shape[0] * x.shape[1]
        bm = x.mean(dim=(0, 1))
        bv = x.var(dim=(0, 1), unbiased=False) * (n / max(n - 1, 1))
        m = self.MOMENTUM
        return dict(new_params, mean=(1 - m) * old_params["mean"] + m * bm,
                    var=(1 - m) * old_params["var"] + m * bv)


class Model(nn.Module):
    """A base + CTC model pair built from a config dict as in the JAX
    facade: "wavenet-ctc" is WaveNet (``model_base``) followed by the
    WaveNetClassifier CTC head (``model_ctc``); "raw-ctcnet" is BatchNorm1d
    followed by RawCTCNet, with the JAX facade's defaults (facade.py:101-116:
    2048 features, kernel 3, dilations 1..64 x 20). The config's
    ``use_pallas`` and ``remat`` keys do not apply: causal blocks always run
    the fused block, which is its kernel on the card.

    The chunked forwards of ``inference`` read the model's ``layers``,
    ``entry_kwidth`` / ``feature_kwidth`` and ``output_length``: those of
    the whole pair (BatchNorm is pointwise; a pooled classifier's
    output_length is L // pool, which the chunk grid refuses)."""

    def __init__(self, model_type: str = "wavenet-ctc",
                 cfg: Optional[Dict[str, Any]] = None, *, device=None):
        super().__init__()
        if model_type not in ("wavenet-ctc", "raw-ctcnet"):
            raise ValueError(f"unknown model_type {model_type!r}")
        self.model_type = model_type
        self.device = resolve_device(device)
        cfg = cfg or {}
        if model_type == "raw-ctcnet":
            r = raw_ctcnet_cfg(cfg)
            self.model_base = BatchNorm1d(1, device=self.device)
            self.model_ctc = RawCTCNet(r["num_features"], r["feature_kwidth"],
                                       r["num_labels"], r["layers"], r["out_dim"],
                                       softmax=False, causal=r["causal"],
                                       device=self.device)
            self.feature_kwidth = r["feature_kwidth"]
        else:
            b, c = base_model_cfg(cfg), classifier_cfg(cfg)
            self.model_base = WaveNet(b["signal_dim"], b["entry_kwidth"],
                                      b["layers"], b["out_dim"], softmax=False,
                                      device=self.device)
            self.model_ctc = WaveNetClassifier(c["in_dim"], c["num_labels"],
                                               c["layers"], c["out_dim"],
                                               pool_kernel_size=c["downsample"],
                                               softmax=False, device=self.device)
            self.entry_kwidth = b["entry_kwidth"]

    @property
    def layers(self):
        """The dilated convs the chunk margin counts, as (c_in, c_out, kernel,
        dilation): RawCTCNet's stack (as JAX's _default_margin reads it), or
        WaveNet's blocks, the classifier's input block and its blocks."""
        if self.model_type == "raw-ctcnet":
            return self.model_ctc.layers
        blk = self.model_ctc.input_block
        return self.model_base.layers + ((blk.in_channels, blk.out_channels,
                                          blk.kernel_width, blk.dilation),) + \
            self.model_ctc.layers

    def output_length(self, L):
        """Logit frames of a signal of L samples."""
        if self.model_type == "raw-ctcnet":
            return self.model_ctc.output_length(L)
        return L // self.model_ctc.pool_kernel_size

    def init(self, seed: Union[int, torch.Generator] = 0) -> "Model":
        """Fresh weights from the port's initialisers on a seeded CPU
        generator (the same weights on every device). Returns self."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        self.model_base.reset_parameters(gen)
        self.model_ctc.reset_parameters(gen)
        return self

    def load_jax(self, tree) -> "Model":
        """Load a JAX param pytree {"base": ..., "ctc": ...} (nested dicts of
        arrays, either stack layout). Returns self."""
        self.load_state_dict(params_from_jax(tree))
        return self

    def eval_base(self) -> nn.Module:
        """The base model in eval mode: BatchNorm1d's eval form (the running
        statistics, sharing the parameters), or WaveNet itself."""
        if isinstance(self.model_base, BatchNorm1d):
            return self.model_base.eval_form()
        return self.model_base

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """A copy of the weights as the train step's tree {"base", "ctc"}."""
        return param_tree(self.model_base, self.model_ctc)

    def save(self, path: str, params=None) -> None:
        """Save a params tree (default: this model's weights) to one torch
        file."""
        save_params(path, self.params() if params is None else params)

    def restore(self, path: str, params_like=None):
        """The params tree saved at ``path``, checked against ``params_like``
        and placed on its devices. Without ``params_like`` it is checked
        against this model's weights and also loaded into the model.
        Returns the tree."""
        params = restore_params(path, self.params() if params_like is None
                                else params_like)
        if params_like is None:
            self.load_params(params)
        return params

    def load_params(self, params) -> "Model":
        """Load a params tree {"base", "ctc"} (``params()``'s layout), as
        a train state holds it. Returns self."""
        self.model_base.load_state_dict(params["base"])
        self.model_ctc.load_state_dict(params["ctc"])
        return self

    def predict(self, signal: torch.Tensor):
        """signal (B, L, signal_dim) -> (base_out, logits), the base in its
        eval form (running-statistics BatchNorm for raw-ctcnet)."""
        base_out = self.eval_base()(signal)
        return base_out, self.model_ctc(base_out)

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        """The CTC logits (B, output_length(L), num_labels)."""
        return self.predict(signal)[1]


class Dataset:
    """Datatype-dispatching loader (facade.py:149-236) with the same keyword
    defaults. ``pore``, ``raw-pore``, ``gauss`` and ``raw-gauss`` are
    generated: the training stream, a separate infinite validation stream
    on seed + 10**6, and with ``static_shapes`` (the default) signals and
    labels padded to the longest possible, so every batch has one shape.
    ``hdf5`` reads the file ``dataset`` through a ``QueueLoader`` (its
    ``nworkers`` producer threads a split, ``queue_size``, ``pad_to``,
    ``labels_pad_to``, ``device_onehot``); its shapes are padded only to
    ``pad_to`` / ``labels_pad_to``, and ``fetch`` raises StopIteration when
    the queue stays empty for a second. ``raw-hdf5`` is unsupported, as in
    the JAX package and the reference."""

    DATATYPES = ("pore", "gauss", "hdf5", "raw-pore", "raw-gauss", "raw-hdf5")
    QUEUE_TYPES = ("hdf5", "raw-hdf5")

    def __init__(self, datatype: str, dataset: Optional[str] = None, **kw):
        if datatype not in self.DATATYPES:
            raise ValueError(f"unknown datatype {datatype!r}")
        if datatype == "raw-hdf5":
            raise NotImplementedError("raw-hdf5 currently unsupported "
                                      "(matches reference Dataset.py:57-58)")
        self.datatype = datatype
        p = dict(max_iters=kw.get("max_iters", 1000), num_epochs=kw.get("num_epochs", 1),
                 epoch_size=kw.get("epoch_size", 1000))
        seed = kw.get("seed")
        common = dict(batch_size=kw.get("batch_size", 8),
                      lengths=(kw.get("min_length", 90), kw.get("max_length", 100)))
        if datatype == "hdf5":
            self.data = QueueLoader(
                dataset, num_epochs=p["num_epochs"], max_iters=p["max_iters"],
                num_workers=kw.get("nworkers", 1), queue_size=kw.get("queue_size", 50),
                batch_size=common["batch_size"], sample_lengths=common["lengths"],
                num_levels=kw.get("num_levels", 256), seed=seed, pad_to=kw.get("pad_to"),
                labels_pad_to=kw.get("labels_pad_to"),
                device_onehot=kw.get("device_onehot", False))
            return
        p_valid = dict(max_iters=2 ** 62, num_epochs=2 ** 30, epoch_size=p["epoch_size"])
        vseed = None if seed is None else seed + 10 ** 6
        upsampling = kw.get("upsampling", 4)

        def make(pp, s):
            if datatype in ("pore", "raw-pore"):
                return PoreModelLoader(
                    **pp, **common, num_levels=kw.get("num_levels", 256),
                    pore_width=kw.get("pore_width", 4), sample_rate=upsampling,
                    currents_dict=DEFAULT_CURRENTS, sample_noise=kw.get("sample_noise", 2.0),
                    raw_signal=datatype == "raw-pore", seed=s)
            if datatype == "gauss":
                return GaussianModelLoader(**pp, **common, num_levels=kw.get("num_levels", 256),
                                           upsampling=upsampling, seed=s)
            return RawGaussianModelLoader(**pp, **common, upsampling=upsampling, seed=s)

        self.data, self.valid_data = make(p, seed), make(p_valid, vseed)
        if kw.get("static_shapes", True):
            for ld in (self.data, self.valid_data):
                ld.pad_to = ld.max_signal_length
                ld.labels_pad_to = ld.max_label_length

    @property
    def signal_channels(self) -> int:
        return getattr(self.data, "signal_channels", 256)

    def fetch(self, train_or_valid: str = "train") -> Batch:
        """The next batch of a stream ("train" or "valid"); StopIteration when
        the training stream's max_iters or num_epochs is reached, or when a
        queue stays empty."""
        if self.datatype in self.QUEUE_TYPES:
            return self.data.dequeue(from_queue=train_or_valid)
        return (self.valid_data if train_or_valid == "valid" else self.data).fetch()

    def close(self) -> None:
        """Stop a queue's producer threads and close its file (nothing to do
        for the generated datatypes)."""
        if self.datatype in self.QUEUE_TYPES:
            self.data.close()


class Decoder:
    """'argmax' or 'beam' decoding of (B, T, C) logits to strings
    (facade.py:239-310). Beam engines: 'device', the batched prefix beam
    search of ``decoding.ctc_beam_device`` (the B6 kernel on a CUDA
    tensor, its plain version on a CPU one), 'native', the host C++
    decoder of ``native.ctc_beam`` (the logits copied to the host), and
    'python', the numpy reference ``decoding.prefix_beam``. ``prune`` keeps
    a frame's top-K labels as extension candidates (device engine only;
    None is exact)."""

    def __init__(self, decoder: str = "argmax", beam_width: int = 7, blank: int = 0,
                 engine: str = "device", prune: Optional[int] = None):
        if decoder not in ("argmax", "beam"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if engine not in ("device", "native", "python"):
            raise ValueError(f"unknown engine {engine!r}")
        self.decoder_type, self.beam_width, self.blank = decoder, beam_width, blank
        self.engine, self.prune = engine, prune

    def decode(self, logits, lengths=None, return_times: bool = False):
        """logits (B, T, C), a tensor (on any device) or an array; lengths
        (B,) valid frames (default T). -> (scores, strings[, times]):
        scores None for argmax; times, one list a sequence of the frame at
        which each label was emitted, from the device and native engines."""
        if self.decoder_type == "argmax":
            if return_times:
                raise ValueError("times are a beam-engine output")
            return None, greedy_ctc_decode(torch.as_tensor(logits), lengths, self.blank)
        if self.engine != "device":
            logits = (logits.detach().float().cpu().numpy() if torch.is_tensor(logits)
                      else np.asarray(logits))
            lengths = (lengths.detach().cpu().numpy() if torch.is_tensor(lengths)
                       else lengths)
        if self.engine == "native":
            labels, lens, scores, times = ctc_beam_search_native(
                logits, beam_width=self.beam_width, blank=self.blank, lengths=lengths,
                return_times=True)
            out = ([float(s) for s in scores],
                   labels2strings([labels[b, :lens[b]] for b in range(labels.shape[0])]))
            if return_times:
                out += ([times[b, :lens[b]].tolist() for b in range(labels.shape[0])],)
            return out
        if self.engine == "python":
            if return_times:
                raise ValueError("times need the 'device' or 'native' engine")
            results, scores = beam_search_decode(np.asarray(logits), self.beam_width,
                                                 self.blank, lengths)
            return scores, labels2strings(results)
        prefixes, plens, scores, times = ctc_beam_search(
            torch.as_tensor(logits), lengths, beam_width=self.beam_width, blank=self.blank,
            return_times=True, prune=self.prune)
        prefixes, plens, times = (x.cpu().numpy() for x in (prefixes, plens, times))
        out = ([float(s) for s in scores[:, 0].cpu()],
               labels2strings([prefixes[b, 0, :plens[b, 0]] for b in range(len(plens))]))
        if return_times:
            out += ([times[b, 0, :plens[b, 0]].tolist() for b in range(len(plens))],)
        return out
