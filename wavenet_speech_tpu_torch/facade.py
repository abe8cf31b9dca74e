"""Facade (wavenet_speech_tpu/facade.py): the base + CTC model pair and the
datatype-dispatching dataset.

    model = Model("wavenet-ctc", cfg).init(seed=0)       # or .load_jax(tree)
    base_out, logits = model.predict(signal)               # (B, L, C) NLC
    data = Dataset("pore", batch_size=8, seed=0)
    batch = data.fetch("train")                            # data.Batch, numpy

``Model`` runs on ``cuda`` unless ``device`` is given, and raises when no
CUDA device is present and none was given. ``Model("raw-ctcnet")`` serves:
``BatchNorm1d`` normalizes with its running statistics, then RawCTCNet;
training it (``BatchNorm1d.update_state``, the CTC-only step) is not ported
yet (ROADMAP A8). ``Decoder`` of the JAX facade, and every ``Dataset``
datatype but ``pore``, are not ported yet (ROADMAP A9, A10).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from wavenet_speech_tpu_torch.bridge import params_from_jax
from wavenet_speech_tpu_torch.data.common import Batch
from wavenet_speech_tpu_torch.data.pore_model import DEFAULT_CURRENTS, PoreModelLoader
from wavenet_speech_tpu_torch.models import RawCTCNet, WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.training.checkpoint import restore_params, save_params
from wavenet_speech_tpu_torch.training.trainer import param_tree
from wavenet_speech_tpu_torch.utils.config import (base_model_cfg, classifier_cfg,
                                                   raw_ctcnet_cfg)
from wavenet_speech_tpu_torch.utils.device import resolve_device


class BatchNorm1d(nn.Module):
    """Batch normalization over (batch, time) of raw signals, the base model
    of the raw-ctcnet pair (facade.py:36-80), in its eval form only
    (``use_running=True``): normalized with the running mean and variance.
    gamma, beta, mean and var are all parameters, as they are leaves of the
    JAX params tree. The training form (batch statistics) and
    ``update_state``, its running-statistics EMA, are not ported yet
    (ROADMAP A8): the train and eval steps refuse a model that carries
    ``not_trainable``."""

    not_trainable = ("training raw-ctcnet is not ported yet (ROADMAP A8: BatchNorm1d's "
                     "training form and update_state, ops/norm.py, make_ctc_train_step); "
                     "the port serves it")

    def __init__(self, num_features: int = 1, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        for name in ("gamma", "beta", "mean", "var"):
            self.register_parameter(name, nn.Parameter(
                torch.empty((num_features,), device=device)))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for p, v in ((self.gamma, 1.0), (self.beta, 0.0), (self.mean, 0.0),
                         (self.var, 1.0)):
                p.fill_(v)

    def forward(self, x):
        return self.gamma * (x - self.mean) * torch.rsqrt(self.var + self.eps) + self.beta

    def update_state(self, *args, **kwargs):
        raise NotImplementedError(self.not_trainable)


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
        """The base model in eval mode: ``model_base`` itself (BatchNorm1d
        has only its eval form; WaveNet holds no statistics)."""
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
        base_out = self.model_base(signal)
        return base_out, self.model_ctc(base_out)

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        """The CTC logits (B, output_length(L), num_labels)."""
        return self.predict(signal)[1]


class Dataset:
    """Datatype-dispatching loader (facade.py:149-236) with the same keyword
    defaults. ``pore`` is ported: the training stream, a separate infinite
    validation stream on seed + 10**6, and static shapes (signals padded to
    the longest possible, so every batch has one shape). The other
    datatypes raise NotImplementedError."""

    DATATYPES = ("pore", "gauss", "hdf5", "raw-pore", "raw-gauss", "raw-hdf5")

    def __init__(self, datatype: str, dataset: Optional[str] = None, **kw):
        if datatype not in self.DATATYPES:
            raise ValueError(f"unknown datatype {datatype!r}")
        if datatype != "pore":
            raise NotImplementedError(
                f"datatype {datatype!r} is not ported yet (ROADMAP A9: the gauss, "
                f"raw and hdf5 loaders); the port trains on 'pore'")
        self.datatype = datatype
        p = dict(max_iters=kw.get("max_iters", 1000), num_epochs=kw.get("num_epochs", 1),
                 epoch_size=kw.get("epoch_size", 1000))
        p_valid = dict(max_iters=2 ** 62, num_epochs=2 ** 30, epoch_size=p["epoch_size"])
        seed = kw.get("seed")
        vseed = None if seed is None else seed + 10 ** 6

        def make(pp, s):
            return PoreModelLoader(
                **pp, batch_size=kw.get("batch_size", 8),
                num_levels=kw.get("num_levels", 256),
                lengths=(kw.get("min_length", 90), kw.get("max_length", 100)),
                pore_width=kw.get("pore_width", 4), sample_rate=kw.get("upsampling", 4),
                currents_dict=DEFAULT_CURRENTS, sample_noise=kw.get("sample_noise", 2.0),
                seed=s)

        self.data, self.valid_data = make(p, seed), make(p_valid, vseed)
        for ld in (self.data, self.valid_data):
            ld.pad_to = ld.max_signal_length
            ld.labels_pad_to = ld.max_label_length

    @property
    def signal_channels(self) -> int:
        return self.data.signal_channels

    def fetch(self, train_or_valid: str = "train") -> Batch:
        """The next batch of a stream; StopIteration when the training
        stream's max_iters or num_epochs is reached."""
        return (self.valid_data if train_or_valid == "valid" else self.data).fetch()
