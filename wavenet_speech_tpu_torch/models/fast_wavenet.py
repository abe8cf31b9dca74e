"""Fast incremental WaveNet generation (wavenet_speech_tpu/models/
fast_wavenet.py): O(1) work a generated sample instead of a forward over
the whole history.

A causal conv (kernel k, dilation d) at time t reads its layer input at t,
t-d, ..., t-(k-1)d (the reference's get_ker_ixs, modules/
linear_conv_ops.py:112-123). Each layer keeps a ring buffer of its last
Q = max((k-1)*d, 1) inputs; a step is the entry conv from the last
entry-kwidth raw frames, then per block the gate product from the ring's
k-1 taps and the current input, the 1x1s and the skip bottleneck, and the
push of the input into the ring; then the output stack and the sample.
Any per-layer kernel width and dilation mix works.

Priming runs the model's own blocks over the prime (``models.blocks.
ResidualBlock``: on the card the fused block kernel, B4, once a block) and
keeps each layer's input history. A step's products are a few (B, C) x
(C, 2C) matmuls, which JAX computes outside any Pallas kernel too.

Sampling: the network predicts the distribution of the NEXT level; argmax,
or with a ``torch.Generator`` a draw from softmax(h / temperature); the
level is fed back one-hot.
"""
from __future__ import annotations

from typing import Optional

import torch

from wavenet_speech_tpu_torch.models.wavenet import WaveNet
from wavenet_speech_tpu_torch.ops.activations import gated_activation, leaky_relu
from wavenet_speech_tpu_torch.ops.conv import causal_conv1d
from wavenet_speech_tpu_torch.utils.device import resolve_device


class _Ring:
    """A layer's last Q inputs, (Q, B, C); ``tap(j)`` is the input at
    t - Q + j for the position t about to be processed."""

    def __init__(self, hist: torch.Tensor, Q: int):
        # the first generated step re-processes the prime's last position,
        # so the ring ENDS one frame before it (JAX init_queue, :112-119)
        B, _, C = hist.shape
        hist = hist[:, :-1]
        pad = hist.new_zeros((B, max(Q - hist.shape[1], 0), C))
        self.q = torch.cat([pad, hist], dim=1)[:, -Q:].transpose(0, 1).contiguous()
        self.oldest, self.Q = 0, Q

    def tap(self, j: int) -> torch.Tensor:
        return self.q[(self.oldest + j) % self.Q]

    def push(self, x: torch.Tensor):
        self.q[self.oldest] = x
        self.oldest = (self.oldest + 1) % self.Q


def _block_step(blk, bn, x_t, ring: _Ring):
    """One timestep of a gated residual block and its skip bottleneck:
    tap m of the kernel multiplies the input at t - (k-1-m)d, ring tap m*d
    for m < k-1 and x_t for m = k-1 (JAX _block_step, :45-65). Returns
    (resid, skip)."""
    k, d, C = blk.kernel_width, blk.dilation, blk.out_channels
    g = torch.addmm(blk.gate_b, x_t, blk.gate_w[k - 1])
    for m in range(k - 1):
        g = g + ring.tap(m * d) @ blk.gate_w[m]
    act = gated_activation(g[:, :C], g[:, C:])
    o = torch.addmm(blk.out_b, act, blk.out_w[0])
    resid = o[:, :C] + torch.addmm(blk.res_b, x_t, blk.res_w)
    return resid, torch.addmm(bn.b, o[:, C:], bn.w)


@torch.no_grad()
def generate(model: WaveNet, prime: torch.Tensor, num_steps: int,
             generator: Optional[torch.Generator] = None, temperature: float = 1.0):
    """Generate ``num_steps`` quantized levels after ``prime``.

    model: a WaveNet (any entry kwidth and block mix; its softmax flag is
    ignored: the output stack's logits are softmaxed here). prime (B, L0,
    in_dim) one-hot, L0 >= 1, on the model's device. generator: a
    torch.Generator on that device for temperature sampling; None gives
    argmax. Returns (levels (B, num_steps) int64, probs (B, num_steps,
    out_dim))."""
    out_dim = model.out2.w.shape[1]
    if model.in_dim != out_dim:
        raise ValueError(
            "one-hot feedback needs in_dim == out_dim: levels drawn from "
            f"{out_dim} classes would be encoded into {model.in_dim} input "
            "channels (out-of-range levels would one-hot to all-zeros)")
    resolve_device(prime.device)
    B, L0, C_in = prime.shape
    blocks, bns = list(model.stack.blocks), list(model.stack.bottlenecks)
    ew, eb = model.entry.w, model.entry.b
    ke = ew.shape[0]

    # priming: the parallel forward over the prime, keeping each layer's input
    h = causal_conv1d(prime, ew, eb)
    rings = []
    for blk in blocks:
        rings.append(_Ring(h, max((blk.kernel_width - 1) * blk.dilation, 1)))
        h, _ = blk(h)

    # the last ke raw frames, ending at prime[:, -1] (zero-padded before it)
    pad = prime.new_zeros((B, max(ke - L0, 0), C_in))
    raw = list(torch.cat([pad, prime], dim=1)[:, -ke:].unbind(1))
    levels, probs = [], []
    for _ in range(num_steps):
        h = eb
        for tap in range(ke):
            h = h + raw[tap] @ ew[tap]
        skips = 0
        for blk, bn, ring in zip(blocks, bns, rings):
            resid, skip = _block_step(blk, bn, h, ring)
            skips = skips + skip
            ring.push(h)
            h = resid
        out = model.out1(leaky_relu(skips))
        out = model.out2(leaky_relu(out))
        p = torch.softmax(out / temperature, dim=-1)
        if generator is None:
            level = p.argmax(dim=-1)
        else:
            level = torch.multinomial(p, 1, generator=generator)[:, 0]
        raw = raw[1:] + [torch.nn.functional.one_hot(level, C_in).to(prime.dtype)]
        levels.append(level)
        probs.append(p)
    if not num_steps:
        return prime.new_zeros((B, 0), dtype=torch.long), prime.new_zeros((B, 0, out_dim))
    return torch.stack(levels, dim=1), torch.stack(probs, dim=1)
