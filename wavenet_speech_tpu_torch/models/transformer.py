"""Bonito's transformer basecaller (github.com/nanoporetech/bonito
``bonito/transformer/model.py``, ``bonito/nn.py``), the model Dorado ships
as ``dna_r10.4.1_e8.2_400bps_sup@v5.0.0``, with a CTC head.

  * stem: convolutions with bias and swish (x * sigmoid(x)), padded by
    k // 2, each (c_in, c_out, k, stride); Bonito's five take a chunk of
    12,288 samples to T = 1,024 frames of 512 channels;
  * ``depth`` encoder layers of ``d_model``, ``nhead`` heads:
      qkv = x Wqkv (no bias), viewed as (T, 3, H, dh); rotary embedding on
      q and k (non-interleaved, base 10,000, all dh dims, the frame index
      in the chunk as the position); softmax attention over the band of
      keys i - left <= j <= i + right (``ops.window_attention``);
      out_proj (with bias);  x = RMSNorm1(attn + alpha x);
      [y, gate] = x W1 (no bias);  mlp = (y * silu(gate)) W2 (no bias);
      x = RMSNorm2(mlp + alpha x),
    RMSNorm flash-attn's (eps 1e-5, a learned scale) and alpha DeepNorm's
    (2 depth)^(1/4);
  * ``LinearUpsample``: 512 -> upsample * 512 with bias, reshaped to
    upsample * T frames;
  * the head: where Bonito has a CRF over 4 bases (``LinearCRFEncoder``),
    a CTC head, Linear(d_model, num_labels) over {blank, A, G, C, T}.

Weights follow the JAX package's layout (dense kernels (C_in, C_out),
conv kernels (K, C_in, C_out)), under the names of the benchmark's
reference (``stem.<i>``, ``layers.<i>.wqkv`` ...). The port's initialiser
is Bonito's: xavier-normal kernels, DeepNorm's beta = (8 depth)^(-1/4) as
the gain of v, out_proj, W1 and W2, zero biases, unit norm scales.

The attention is the kernel on the card and the plain version elsewhere;
RoPE, RMSNorm with its residual and SwiGLU are stock PyTorch. Under an
active ``torch.profiler`` the forward marks ``tx.stem``, ``tx.attention``
(Wqkv, RoPE, the attention, out_proj), ``tx.norm``, ``tx.mlp`` and
``tx.head`` (the upsample and the head) with ``utils.profiling.span``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from wavenet_speech_tpu_torch.ops.window_attention import window_attention
from wavenet_speech_tpu_torch.utils.profiling import span

# (c_in, c_out, kernel, stride) of Bonito sup v5's stem
STEM = ((1, 64, 5, 1), (64, 64, 5, 1), (64, 128, 9, 3), (128, 128, 9, 2), (128, 512, 5, 2))
NORM_EPS = 1e-5
ROTARY_BASE = 10000.0


def _xavier_normal(shape, gain: float, generator) -> torch.Tensor:
    fan_in, fan_out = math.prod(shape[:-1]), shape[-1]
    if len(shape) == 3:       # (K, C_in, C_out): torch counts K in both fans
        fan_out *= shape[0]
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=generator)


class Linear(nn.Module):
    """x @ w (+ b), w (C_in, C_out)."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True, gain: float = 1.0, *,
                 device=None):
        super().__init__()
        self.gain = gain
        self.w = nn.Parameter(torch.empty((c_in, c_out), device=device))
        self.b = nn.Parameter(torch.empty((c_out,), device=device)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.w.copy_(_xavier_normal(tuple(self.w.shape), self.gain, generator))
            if self.b is not None:
                self.b.zero_()

    def forward(self, x):
        y = x @ self.w
        return y if self.b is None else y + self.b


class StemConv(nn.Module):
    """Conv1d with bias and swish, padded by k // 2, on (B, C, L)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, *, device=None):
        super().__init__()
        self.k, self.stride = k, stride
        self.w = nn.Parameter(torch.empty((k, c_in, c_out), device=device))
        self.b = nn.Parameter(torch.empty((c_out,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.w.copy_(_xavier_normal(tuple(self.w.shape), 1.0, generator))
            self.b.zero_()

    def output_length(self, L):
        return (L + 2 * (self.k // 2) - self.k) // self.stride + 1

    def forward(self, x):
        return F.silu(F.conv1d(x, self.w.permute(2, 1, 0), self.b, stride=self.stride,
                               padding=self.k // 2))


class RMSNorm(nn.Module):
    """flash-attn's RMSNorm of (x + residual): a learned scale, eps 1e-5."""

    def __init__(self, d: int, eps: float = NORM_EPS, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty((d,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x, residual):
        h = x + residual
        return h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps) * self.scale


def rotary(T: int, dh: int, device, base: float = ROTARY_BASE):
    """(cos, sin), each (T, 1, dh // 2), of the frame index over base's
    frequencies (flash-attn's ``RotaryEmbedding``, all dh dims)."""
    inv = 1.0 / base ** (torch.arange(0, dh, 2, device=device, dtype=torch.float32) / dh)
    ang = torch.arange(T, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def apply_rotary(x, cos, sin):
    """Non-interleaved rotation of x (B, T, H, dh): the halves
    (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, alpha: float,
                 beta: float, attn_window: Tuple[int, int], *, device=None):
        super().__init__()
        self.nhead, self.alpha, self.beta = nhead, alpha, beta
        self.attn_window = tuple(attn_window)
        self.wqkv = Linear(d_model, 3 * d_model, bias=False, device=device)
        self.out_proj = Linear(d_model, d_model, gain=beta, device=device)
        self.norm1 = RMSNorm(d_model, device=device)
        self.w1 = Linear(d_model, 2 * dim_feedforward, bias=False, gain=beta, device=device)
        self.w2 = Linear(dim_feedforward, d_model, bias=False, gain=beta, device=device)
        self.norm2 = RMSNorm(d_model, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for m in (self.out_proj, self.norm1, self.w1, self.w2, self.norm2):
            m.reset_parameters(generator)
        with torch.no_grad():   # Bonito: q and k at gain 1, v at DeepNorm's
            d = self.wqkv.w.shape[0]
            self.wqkv.w[:, :2 * d] = _xavier_normal((d, 2 * d), 1.0, generator)
            self.wqkv.w[:, 2 * d:] = _xavier_normal((d, d), self.beta, generator)

    def attention(self, x, cos, sin):
        B, T, d = x.shape
        qkv = self.wqkv(x).view(B, T, 3, self.nhead, d // self.nhead)
        q = apply_rotary(qkv[:, :, 0], cos, sin)
        k = apply_rotary(qkv[:, :, 1], cos, sin)
        o = window_attention(q, k, qkv[:, :, 2], self.attn_window)
        return self.out_proj(o.reshape(B, T, d))

    def mlp(self, x):
        y, gate = self.w1(x).chunk(2, dim=-1)
        return self.w2(y * F.silu(gate))

    def forward(self, x, cos, sin):
        with span("tx.attention"):
            h = self.attention(x, cos, sin)
        with span("tx.norm"):
            x = self.norm1(h, self.alpha * x)
        with span("tx.mlp"):
            h = self.mlp(x)
        with span("tx.norm"):
            return self.norm2(h, self.alpha * x)


class TransformerBasecaller(nn.Module):
    """Raw signal (B, L, 1) -> CTC logits (B, output_length(L), num_labels)."""

    def __init__(self, stem: Sequence[Sequence[int]] = STEM, d_model: int = 512,
                 nhead: int = 8, dim_feedforward: int = 2048, depth: int = 18,
                 attn_window: Tuple[int, int] = (127, 128), upsample: int = 2,
                 num_labels: int = 5, *, device=None):
        super().__init__()
        if stem[-1][1] != d_model or d_model % nhead or (d_model // nhead) % 2:
            raise ValueError(f"stem {stem} must end in d_model {d_model}, and nhead {nhead} "
                             f"must split it into heads of even width")
        self.d_model, self.nhead, self.depth = d_model, nhead, depth
        self.upsample_factor, self.num_labels = upsample, num_labels
        self.attn_window = tuple(attn_window)
        self.stem = nn.ModuleList(StemConv(*c, device=device) for c in stem)
        alpha, beta = (2.0 * depth) ** 0.25, (8.0 * depth) ** -0.25
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, alpha, beta, attn_window,
                                    device=device) for _ in range(depth))
        self.upsample = Linear(d_model, upsample * d_model, device=device)
        self.head = Linear(d_model, num_labels, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for m in (*self.stem, *self.layers, self.upsample, self.head):
            m.reset_parameters(generator)

    def frames(self, L):
        """The stem's frames (the attention's T) of a read of L samples."""
        for conv in self.stem:
            L = conv.output_length(L)
        return L

    def output_length(self, L):
        """Logit frames of a read of L samples: the stem's, times the
        upsample."""
        return self.frames(L) * self.upsample_factor

    def forward(self, signal):
        with span("tx.stem"):
            x = signal.transpose(1, 2)
            for conv in self.stem:
                x = conv(x)
            x = x.transpose(1, 2).contiguous()                    # (B, T, d)
        B, T, d = x.shape
        cos, sin = (c.to(x.dtype) for c in rotary(T, d // self.nhead, x.device))
        for layer in self.layers:
            x = layer(x, cos, sin)
        with span("tx.head"):
            x = self.upsample(x).reshape(B, self.upsample_factor * T, d)
            return self.head(x)
