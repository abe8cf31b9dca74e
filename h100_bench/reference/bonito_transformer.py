"""The reference of the bonito_transformer family: Bonito's transformer
basecaller (github.com/nanoporetech/bonito ``bonito/transformer/model.py``,
``bonito/nn.py``; Dorado's ``dna_r10.4.1_e8.2_400bps_sup@v5.0.0``), trained
on the per-logit CTC of a batch standardized with its own statistics.

    stem     x <- swish(conv_{k, stride}(x) + b), padded by k // 2, five times
    layer    qkv = x Wqkv ; q, k rotated (RoPE: non-interleaved, base 10,000,
             every dim of a head, the frame index as the position)
             a = softmax(q k^T / sqrt(dh) + band mask) v, keys j with
                 i - left <= j <= i + right
             x = rmsnorm(a Wo + bo + alpha x) * s1
             [y, g] = x W1 ; x = rmsnorm((y * g sigmoid(g)) W2 + alpha x) * s2
             rmsnorm(h) = h / sqrt(mean(h^2) + eps), alpha = (2 depth)^(1/4)
    upsample x (B, T, d) -> x Wu + bu, reshaped to (B, upsample T, d)
    head     logits = x Wh + bh

Departures from Bonito, each the configuration's (``reduced`` /
``assumed``): a CTC head over {blank, A, G, C, T} where Bonito has a CRF
(``LinearCRFEncoder``, state_len 5); no DeepNorm beta in the weights,
which come from the seed. The attention is a dense softmax under the band
mask, computed over blocks of queries (each against every key) so that
it fits; the CTC runs over every frame in float64 (``ctc.py``)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from h100_bench.reference import nn
from h100_bench.reference.ctc import ctc_nll
from h100_bench.spec import settings

TRAINING = {"step": ("ctc",), "preprocess": ("batch_standardize",), "optimizer": None,
            "learning_rate": None, "weight_decay": None}
MODEL = {k: None for k in ("stem", "d_model", "nhead", "dim_feedforward", "depth",
                          "attn_window", "upsample", "num_labels", "rotary_base", "norm_eps")}
QUERY_ROWS = 256  # queries a block of the dense attention


def param_shapes(cfg) -> Dict[str, tuple]:
    m = settings(cfg["model"], MODEL, "reference bonito_transformer model")
    d, f = m["d_model"], m["dim_feedforward"]
    shapes = {}
    for i, (c_in, c_out, k, _) in enumerate(m["stem"]):
        shapes.update({f"stem.{i}.w": (k, c_in, c_out), f"stem.{i}.b": (c_out,)})
    for i in range(m["depth"]):
        n = f"layers.{i}"
        shapes.update({f"{n}.wqkv.w": (d, 3 * d), f"{n}.out_proj.w": (d, d),
                       f"{n}.out_proj.b": (d,), f"{n}.norm1.scale": (d,),
                       f"{n}.w1.w": (d, 2 * f), f"{n}.w2.w": (f, d), f"{n}.norm2.scale": (d,)})
    shapes.update({"upsample.w": (d, m["upsample"] * d), "upsample.b": (m["upsample"] * d,),
                   "head.w": (d, m["num_labels"]), "head.b": (m["num_labels"],)})
    return shapes


def _rope(x, base: float):
    """x (B, T, H, dh) rotated: x cos + rotate_half(x) sin, the angle of
    dims f and f + dh/2 at frame t being t base^(-2f/dh)."""
    T, dh = x.shape[1], x.shape[-1]
    freq = base ** (-torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = torch.outer(torch.arange(T, dtype=torch.float64, device=x.device), freq)
    ang = torch.cat([ang, ang], dim=-1).to(x.dtype)[None, :, None, :]
    half = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], dim=-1)
    return x * torch.cos(ang) + half * torch.sin(ang)


def _attention(q, k, v, left: int, right: int):
    """Dense softmax attention under the band mask, QUERY_ROWS queries a
    block, each against all T keys."""
    T, dh = q.shape[1], q.shape[-1]
    keys = torch.arange(T, device=q.device)
    out = []
    for lo in range(0, T, QUERY_ROWS):
        rows = torch.arange(lo, min(T, lo + QUERY_ROWS), device=q.device)
        s = torch.einsum("bihd,bjhd->bhij", q[:, lo:lo + QUERY_ROWS], k) / math.sqrt(dh)
        band = (keys[None, :] >= rows[:, None] - left) & (keys[None, :] <= rows[:, None] + right)
        s = s.masked_fill(~band, float("-inf"))
        out.append(torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=1)


def _rmsnorm(h, scale, eps: float):
    return h / torch.sqrt((h * h).mean(dim=-1, keepdim=True) + eps) * scale


def serve_logits(p: nn.Params, signal, cfg):
    """signal (B, L, 1) standardized pico-amps -> logits (B, frames(L),
    labels)."""
    m = cfg["model"]
    x = signal.transpose(1, 2)
    for i, (_, _, k, stride) in enumerate(m["stem"]):
        w = p[f"stem.{i}.w"].permute(2, 1, 0)
        x = F.conv1d(x, w, p[f"stem.{i}.b"], stride=stride, padding=k // 2)
        x = x * torch.sigmoid(x)
    x = x.transpose(1, 2)
    B, T, d = x.shape
    H = m["nhead"]
    alpha = (2.0 * m["depth"]) ** 0.25
    left, right = m["attn_window"]
    for i in range(m["depth"]):
        n = f"layers.{i}"
        qkv = (x @ p[f"{n}.wqkv.w"]).reshape(B, T, 3, H, d // H)
        q, k = (_rope(qkv[:, :, j], m["rotary_base"]) for j in (0, 1))
        a = _attention(q, k, qkv[:, :, 2], left, right).reshape(B, T, d)
        x = _rmsnorm(a @ p[f"{n}.out_proj.w"] + p[f"{n}.out_proj.b"] + alpha * x,
                     p[f"{n}.norm1.scale"], m["norm_eps"])
        y, g = (x @ p[f"{n}.w1.w"]).split(m["dim_feedforward"], dim=-1)
        x = _rmsnorm((y * g * torch.sigmoid(g)) @ p[f"{n}.w2.w"] + alpha * x,
                     p[f"{n}.norm2.scale"], m["norm_eps"])
    x = (x @ p["upsample.w"] + p["upsample.b"]).reshape(B, m["upsample"] * T, d)
    return x @ p["head.w"] + p["head.b"]


def stem_frames(cfg, L: int) -> int:
    """The stem's frames (the attention's T) of a read of L samples."""
    for _, _, k, stride in cfg["model"]["stem"]:
        L = (L + 2 * (k // 2) - k) // stride + 1
    return L


def frames(cfg, L: int) -> int:
    """The logit frames of a read of L samples."""
    return stem_frames(cfg, L) * cfg["model"]["upsample"]


def prepare(cfg, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The signal standardized over the whole batch (padding included),
    before it is cut into blocks of rows."""
    settings(cfg["training"], TRAINING, "reference bonito_transformer training")
    return dict(batch, signal=nn.standardize(batch["signal"]))


def loss_rows(cfg, p: nn.Params, batch, lo: int, hi: int) -> torch.Tensor:
    """The share of rows lo:hi in the batch-summed CTC over T (float64)."""
    logits = serve_logits(p, batch["signal"][lo:hi], cfg)
    n, T = logits.shape[:2]
    full = torch.full((n,), T, dtype=torch.long, device=logits.device)
    return ctc_nll(logits, full, batch["labels"][lo:hi], batch["label_lengths"][lo:hi]).sum() / T
