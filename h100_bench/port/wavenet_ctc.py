"""The wavenet_ctc pair as its users build it: ``facade.Model("wavenet-ctc",
cfg)`` (WaveNet, then the pooled WaveNetClassifier), trained by
``training.make_joint_train_step`` with ``JointLoss("joint")`` in the
configuration's dtype (float32, or the port's bfloat16 mixed precision),
and served by ``inference.Basecaller`` in float32. A dtype or a training
setting this module does not pass on to the port raises."""
from __future__ import annotations

import torch
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.inference import Basecaller
from wavenet_speech_tpu_torch.training import (JointLoss, build_optimizer,
                                               make_joint_train_step)

from h100_bench.spec import settings

TRAIN_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # the step's compute_dtype
SERVE_DTYPES = ("float32",)
TRAINING = {"step": ("joint",), "optimizer": None, "learning_rate": None}


def tree(flat):
    """{"base": {...}, "ctc": {...}} of the flat names "base.<leaf>",
    "ctc.<leaf>"."""
    out = {}
    for name, v in flat.items():
        head, leaf = name.split(".", 1)
        out.setdefault(head, {})[leaf] = v
    return out


def build(cfg, device):
    return Model("wavenet-ctc", cfg, device=device)


def load(model, flat):
    """The weights loaded into the model; returns the train state's params
    tree ({"base", "ctc"}), a copy."""
    model.load_params(tree(flat))
    return model.params()


def optimizer(cfg):
    t = settings(cfg["training"], TRAINING, "port wavenet_ctc training")
    return build_optimizer(t["optimizer"], t["learning_rate"])


def make_step(cfg, model, tx):
    settings({"dtype": cfg["dtype"]}, {"dtype": tuple(TRAIN_DTYPES)}, "port wavenet_ctc step")
    settings(cfg["training"], TRAINING, "port wavenet_ctc training")
    return make_joint_train_step(model.model_base, model.model_ctc, tx,
                                 JointLoss(cfg["training"]["step"]),
                                 compute_dtype=TRAIN_DTYPES[cfg["dtype"]])


def basecaller(cfg, model, mix, device):
    settings({"dtype": cfg["dtype"]}, {"dtype": SERVE_DTYPES}, "port wavenet_ctc serving")
    return Basecaller(model, beam_width=mix["beam_width"], pad_to_multiple=mix["bucket"],
                      logit_length_fn=model.output_length, device=device)
