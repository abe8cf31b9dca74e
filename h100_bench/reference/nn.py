"""The layers the reference's model families share, in plain PyTorch
written from the reference's equations (the gated block, the skip-sum
stack, the output stack, standardization), float32 with TF32 off unless
the caller turns it on. Tensors are (B, L, C). Parameters are a flat dict
keyed by the names both sides share (a family's ``param_shapes``).

    gate  = conv_d(x; gate_w) + gate_b        (K taps, causal or centred)
    act   = tanh(gate[:, :C]) * sigmoid(gate[:, C:])
    o     = act @ out_w + out_b
    resid = o[:, :C] + x @ res_w + res_b ;  skip = o[:, C:]
    skips = sum over blocks of skip @ bottleneck_w + bottleneck_b

A centred ("non-causal") conv pads (K-1)d frames, the odd one on the left.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Layer = Tuple[int, int, int, int]  # c_in, c_out, kernel, dilation


def leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def conv(x, w, dilation: int, left: int, right: int):
    """x (B, L, C_in) cross-correlated with w (K, C_in, C_out), padded with
    left and right zero frames."""
    xp = F.pad(x.transpose(1, 2), (left, right))
    return F.conv1d(xp, w.permute(2, 1, 0), dilation=dilation).transpose(1, 2)


def block(x, p: Params, name: str, dilation: int, causal: bool):
    gw = p[f"{name}.gate_w"]
    total = (gw.shape[0] - 1) * dilation
    left = total if causal else (total + 1) // 2
    C = p[f"{name}.res_w"].shape[1]
    g = conv(x, gw, dilation, left, total - left) + p[f"{name}.gate_b"]
    act = torch.tanh(g[..., :C]) * torch.sigmoid(g[..., C:])
    o = act @ p[f"{name}.out_w"][0] + p[f"{name}.out_b"]
    return o[..., :C] + x @ p[f"{name}.res_w"] + p[f"{name}.res_b"], o[..., C:]


def skip_stack(x, p: Params, name: str, layers: List[Layer], causal: bool, skips):
    for i, (_, _, _, d) in enumerate(layers):
        x, skip = block(x, p, f"{name}.blocks.{i}", d, causal)
        skips = skips + skip @ p[f"{name}.bottlenecks.{i}.w"] + p[f"{name}.bottlenecks.{i}.b"]
    return x, skips


def out_stack(skips, p: Params, name: str = ""):
    h = leaky(skips) @ p[f"{name}out1.w"] + p[f"{name}out1.b"]
    return leaky(h) @ p[f"{name}out2.w"] + p[f"{name}out2.b"]


def block_shapes(name, c_in, c_out, k):
    return {f"{name}.gate_w": (k, c_in, 2 * c_out), f"{name}.gate_b": (2 * c_out,),
            f"{name}.out_w": (1, c_out, 2 * c_out), f"{name}.out_b": (2 * c_out,),
            f"{name}.res_w": (c_in, c_out), f"{name}.res_b": (c_out,)}


def stack_shapes(name, layers, out_dim):
    s = {}
    for i, (ci, co, k, _) in enumerate(layers):
        s.update(block_shapes(f"{name}.blocks.{i}", ci, co, k))
        s[f"{name}.bottlenecks.{i}.w"] = (co, out_dim)
        s[f"{name}.bottlenecks.{i}.b"] = (out_dim,)
    return s


def dense(name, c_in, c_out):
    return {f"{name}.w": (c_in, c_out), f"{name}.b": (c_out,)}


def standardize(x, eps: float = 1e-5):
    """Zero mean, unit biased variance over every axis but the last,
    padding frames included (BatchNorm1d(1)'s training statistics without
    its affine)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)
