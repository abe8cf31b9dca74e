"""RawCTCNet at the reference's eval architecture, built and trained as
``examples/gaussian_eval.py`` does: the device resolved by
``utils.device.resolve_device``, which sets the port's numerics (float32
with TF32 off, deterministic cuDNN), ``models.RawCTCNet`` (no positions,
centred blocks, no softmax) and ``training.make_ctc_train_step`` with
``ops.norm.batch_standardize`` as its preprocess. A dtype or a training
setting this module does not pass on to the port raises; serving is not
adapted."""
from __future__ import annotations

from wavenet_speech_tpu_torch.models import RawCTCNet
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training import build_optimizer
from wavenet_speech_tpu_torch.training.trainer import make_ctc_train_step
from wavenet_speech_tpu_torch.utils.device import resolve_device

from h100_bench.reference.raw_ctcnet import layers
from h100_bench.spec import settings

DTYPES = ("float32",)
PREPROCESS = {"batch_standardize": batch_standardize}
TRAINING = {"step": ("ctc",), "preprocess": tuple(PREPROCESS), "optimizer": None,
            "learning_rate": None}


def build(cfg, device):
    settings({"dtype": cfg["dtype"]}, {"dtype": DTYPES}, "port raw_ctcnet")
    device = resolve_device(device)
    m = cfg["model"]
    return RawCTCNet(m["num_features"], m["feature_kwidth"], m["num_labels"], layers(cfg),
                     m["out_dim"], input_kernel_size=m["input_kernel_size"], positions=False,
                     softmax=False, causal=False, device=device)


def load(model, flat):
    """The weights loaded into the net; returns the train state's params, a
    copy of its state dict."""
    model.load_state_dict(flat)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def optimizer(cfg):
    t = settings(cfg["training"], TRAINING, "port raw_ctcnet training")
    return build_optimizer(t["optimizer"], t["learning_rate"])


def make_step(cfg, model, tx):
    t = settings(cfg["training"], TRAINING, "port raw_ctcnet training")
    return make_ctc_train_step(model, tx, preprocess=PREPROCESS[t["preprocess"]])


def basecaller(cfg, model, mix, device):
    raise NotImplementedError("port raw_ctcnet: no basecall adapter (serving raw reads "
                              "standardizes with running statistics; not adapted)")
