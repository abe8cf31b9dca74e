"""The reference of the raw_ctcnet family: RawCTCNet (a featurizer over
raw pico-amps, an input block, centred gated blocks, the output stack)
trained on the per-logit CTC of a batch standardized with its own
statistics."""
from __future__ import annotations

from typing import Dict, List

import torch

from h100_bench.reference import nn
from h100_bench.reference.ctc import ctc_nll
from h100_bench.spec import settings

TRAINING = {"step": ("ctc",), "preprocess": ("batch_standardize",), "optimizer": None,
            "learning_rate": None}
MODEL = {k: None for k in ("num_features", "feature_kwidth", "num_labels", "nhid", "kernels",
                          "dilations", "cycles", "out_dim", "input_kernel_size")}


def layers(cfg) -> List[nn.Layer]:
    """The centred blocks: every kernel width over the dilations, cycled."""
    m = cfg["model"]
    n = m["nhid"]
    return [(n, n, k, d) for k in m["kernels"] for d in m["dilations"] * m["cycles"]]


def param_shapes(cfg) -> Dict[str, tuple]:
    m = settings(cfg["model"], MODEL, "reference raw_ctcnet model")
    Fe, fk, out, c0 = m["num_features"], m["feature_kwidth"], m["out_dim"], m["nhid"]
    shapes = {"feat_conv.w": (fk, 1, Fe), "feat_conv.b": (Fe,),
              "feat_1x1.w": (1, Fe, Fe), "feat_1x1.b": (Fe,)}
    shapes.update(nn.block_shapes("input_block", Fe, c0, m["input_kernel_size"]))
    shapes.update(nn.dense("input_bottleneck", c0, out))
    shapes.update(nn.stack_shapes("stack", layers(cfg), out))
    shapes.update(nn.dense("out1", out, out))
    shapes.update(nn.dense("out2", out, m["num_labels"]))
    return shapes


def serve_logits(p: nn.Params, signal, cfg):
    """signal (B, L, 1) standardized pico-amps -> logits (B, L + fk - 1,
    labels). The featurizer pads fk - 1 frames on both sides and keeps all
    of them (the reference's quirk)."""
    fk = p["feat_conv.w"].shape[0]
    x = nn.leaky(nn.conv(signal, p["feat_conv.w"], 1, fk - 1, fk - 1) + p["feat_conv.b"])
    x = nn.leaky(x @ p["feat_1x1.w"][0] + p["feat_1x1.b"])
    x, skip = nn.block(x, p, "input_block", 1, False)
    skips = skip @ p["input_bottleneck.w"] + p["input_bottleneck.b"]
    _, skips = nn.skip_stack(x, p, "stack", layers(cfg), False, skips)
    return nn.out_stack(skips, p)


def frames(cfg, L: int) -> int:
    """The logit frames of a read of L samples."""
    return L + cfg["model"]["feature_kwidth"] - 1


def prepare(cfg, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The signal standardized over the whole batch (the statistics are the
    batch's, padding included), before it is cut into blocks of rows."""
    settings(cfg["training"], TRAINING, "reference raw_ctcnet training")
    return dict(batch, signal=nn.standardize(batch["signal"]))


def loss_rows(cfg, p: nn.Params, batch, lo: int, hi: int) -> torch.Tensor:
    """The share of rows lo:hi in the batch-summed CTC over T (float64)."""
    logits = serve_logits(p, batch["signal"][lo:hi], cfg)
    n, T = logits.shape[:2]
    full = torch.full((n,), T, dtype=torch.long, device=logits.device)
    return ctc_nll(logits, full, batch["labels"][lo:hi], batch["label_lengths"][lo:hi]).sum() / T
