"""Bonito's transformer basecaller, built and trained as the port's CTC
path trains a network alone: the device resolved by
``utils.device.resolve_device``, which sets the port's numerics (float32
with TF32 off, deterministic cuDNN), ``models.TransformerBasecaller`` (the
band's kernel on the card) and ``training.make_ctc_train_step`` with
``ops.norm.batch_standardize`` as its preprocess, under
``build_optimizer``'s rule (AdamW: the multi-tensor Adam and weight-decay
kernels). A dtype, a model setting or a training setting this module does
not pass on to the port raises; serving is not adapted."""
from __future__ import annotations

from wavenet_speech_tpu_torch.models import TransformerBasecaller
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training import build_optimizer
from wavenet_speech_tpu_torch.training.trainer import make_ctc_train_step
from wavenet_speech_tpu_torch.utils.device import resolve_device

from h100_bench.spec import settings

DTYPES = ("float32",)
PREPROCESS = {"batch_standardize": batch_standardize}
TRAINING = {"step": ("ctc",), "preprocess": tuple(PREPROCESS), "optimizer": None,
            "learning_rate": None, "weight_decay": None}
# the port's fixed constants, which a configuration may only restate
MODEL = {"stem": None, "d_model": None, "nhead": None, "dim_feedforward": None, "depth": None,
         "attn_window": None, "upsample": None, "num_labels": None, "rotary_base": (10000,),
         "norm_eps": (1e-05,)}


def build(cfg, device):
    settings({"dtype": cfg["dtype"]}, {"dtype": DTYPES}, "port bonito_transformer")
    m = settings(cfg["model"], MODEL, "port bonito_transformer model")
    return TransformerBasecaller(m["stem"], m["d_model"], m["nhead"], m["dim_feedforward"],
                                 m["depth"], tuple(m["attn_window"]), m["upsample"],
                                 m["num_labels"], device=resolve_device(device))


def load(model, flat):
    """The weights loaded into the net; returns the train state's params, a
    copy of its state dict."""
    model.load_state_dict(flat)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def optimizer(cfg):
    t = settings(cfg["training"], TRAINING, "port bonito_transformer training")
    return build_optimizer(t["optimizer"], t["learning_rate"], weight_decay=t["weight_decay"])


def make_step(cfg, model, tx):
    t = settings(cfg["training"], TRAINING, "port bonito_transformer training")
    return make_ctc_train_step(model, tx, preprocess=PREPROCESS[t["preprocess"]])


def basecaller(cfg, model, mix, device):
    raise NotImplementedError("port bonito_transformer: no basecall adapter")
