"""The reference of the wavenet_ctc family: WaveNet (causal blocks over a
one-hot signal, next-level logits) then WaveNetClassifier (average pooling,
centred blocks, CTC logits), trained on the joint objective: next-level
cross-entropy, a mean over every predicted frame of the batch, plus the
batch-summed CTC over the logit frames T."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from h100_bench.reference import nn
from h100_bench.reference.ctc import ctc_nll
from h100_bench.spec import settings

TRAINING = {"step": ("joint",), "optimizer": None, "learning_rate": None}
MODEL = {"base": {"signal_dim": None, "entry_kwidth": None, "kernel": None, "dilations": None,
                  "out_dim": None},
         "classifier": {"in_dim": None, "num_labels": None, "kernel": None, "dilations": None,
                        "downsample": None, "out_dim": None}}


def layers(cfg) -> Tuple[List[nn.Layer], List[nn.Layer]]:
    """(the WaveNet's causal layers, the classifier's centred ones)."""
    m = cfg["model"]
    b, c = m["base"], m["classifier"]
    C = b["signal_dim"]
    return ([(C, C, b["kernel"], d) for d in b["dilations"]],
            [(C, C, c["kernel"], d) for d in c["dilations"]])


def param_shapes(cfg) -> Dict[str, tuple]:
    m = cfg["model"]
    settings(m, {"base": None, "classifier": None}, "reference wavenet_ctc model")
    for part in ("base", "classifier"):
        settings(m[part], MODEL[part], f"reference wavenet_ctc model.{part}")
    b, c = m["base"], m["classifier"]
    wl, cl = layers(cfg)
    C, out, k0 = b["signal_dim"], b["out_dim"], wl[0][0]
    shapes = {"base.entry.w": (b["entry_kwidth"], C, k0), "base.entry.b": (k0,)}
    shapes.update(nn.stack_shapes("base.stack", wl, out))
    shapes.update(nn.dense("base.out1", out, out))
    shapes.update(nn.dense("base.out2", out, out))
    c0, cout = cl[0][0], c["out_dim"]
    shapes.update(nn.block_shapes("ctc.input_block", c["in_dim"], c0, 2))
    shapes.update(nn.dense("ctc.input_bottleneck", c0, cout))
    shapes.update(nn.stack_shapes("ctc.stack", cl, cout))
    shapes.update(nn.dense("ctc.out1", cout, cout))
    shapes.update(nn.dense("ctc.out2", cout, c["num_labels"]))
    return shapes


def wavenet(p: nn.Params, signal, cfg):
    """signal (B, L, levels) one-hot -> next-level logits (B, L, out)."""
    wl, _ = layers(cfg)
    w = p["base.entry.w"]
    x = nn.conv(signal, w, 1, w.shape[0] - 1, 0) + p["base.entry.b"]
    B, L, _ = x.shape
    skips = x.new_zeros((B, L, p["base.out1.w"].shape[0]))
    _, skips = nn.skip_stack(x, p, "base.stack", wl, True, skips)
    return nn.out_stack(skips, p, "base.")


def classifier(p: nn.Params, feats, cfg):
    """WaveNet features (B, L, C) -> CTC logits (B, L // pool, labels)."""
    _, cl = layers(cfg)
    pool = cfg["model"]["classifier"]["downsample"]
    B, L, C = feats.shape
    Lo = L // pool
    x = feats[:, :Lo * pool].reshape(B, Lo, pool, C).mean(dim=2)
    x, skip = nn.block(x, p, "ctc.input_block", 1, False)
    skips = skip @ p["ctc.input_bottleneck.w"] + p["ctc.input_bottleneck.b"]
    _, skips = nn.skip_stack(x, p, "ctc.stack", cl, False, skips)
    return nn.out_stack(skips, p, "ctc.")


def serve_logits(p: nn.Params, x, cfg):
    """The served CTC logits of a one-hot signal x (B, L, levels)."""
    return classifier(p, wavenet(p, x, cfg), cfg)


def frames(cfg, L: int) -> int:
    """The logit frames of a read of L samples."""
    return L // cfg["model"]["classifier"]["downsample"]


def prepare(cfg, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    settings(cfg["training"], TRAINING, "reference wavenet_ctc training")
    return batch


def loss_rows(cfg, p: nn.Params, batch, lo: int, hi: int) -> torch.Tensor:
    """The share of rows lo:hi in the joint objective (float64); batch
    holds (B, L) int32 levels."""
    B = batch["labels"].shape[0]
    levels = batch["signal"][lo:hi].long()
    signal = torch.nn.functional.one_hot(levels, cfg["model"]["base"]["signal_dim"]).float()
    pred = wavenet(p, signal, cfg)
    logits = classifier(p, pred, cfg)
    logp = torch.log_softmax(pred[:, :-1].double(), dim=-1)
    nll = -logp.gather(2, levels[:, 1:, None])[..., 0]
    xe = nll.sum() / (B * levels.shape[1])
    n, T = logits.shape[:2]
    full = torch.full((n,), T, dtype=torch.long, device=logits.device)
    ctc = ctc_nll(logits, full, batch["labels"][lo:hi], batch["label_lengths"][lo:hi]).sum()
    return xe + ctc / T
