"""Attentional fully-convolutional decoder (FAIRSeq-style;
wavenet_speech_tpu/models/conv_decoder.py, reference
modules/conv_decoder.py:66-489), the reference's exploratory seq2seq
decoder, which no training script there uses.

Each layer (conv_decoder.py:192-202): [LayerNorm] -> causal GLU conv block
(two causal convs, k, d=1; GLU(a, b) = a * sigmoid(b), + a Linear residual
of the block input) -> + a Linear residual of the embedded targets -> +
dot-product attention over the encoding. The attention normalizes the raw
dot products by their sum, not by a softmax, as the reference does
(conv_decoder.py:433-474).

Layout NLC. Parameters carry the JAX tree's names; the Linear layers keep
its (out, in) weights (``models.rnn_decoder.Linear``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from wavenet_speech_tpu_torch.models.rnn_decoder import Linear, xavier_normal
from wavenet_speech_tpu_torch.ops.conv import CausalConv1d
from wavenet_speech_tpu_torch.ops.norm import LayerNorm


def glu(x, y):
    """x * sigmoid(y) (reference GLU, conv_decoder.py:485-486)."""
    return x * torch.sigmoid(y)


class _Attention(nn.Module):
    def __init__(self, cout: int, E: int, enc: int, device):
        super().__init__()
        self.in2enc = Linear(cout, enc, device=device)
        self.lab2enc = Linear(E, enc, device=device)
        self.enc2in = Linear(enc, cout, device=device)

    def reset_parameters(self, generator):
        for m in (self.in2enc, self.lab2enc, self.enc2in):
            m.reset_parameters(generator)

    def forward(self, in_seq, enc_seq, embedded_targets):
        """in_seq (B, T, C), enc_seq (B, Le, enc) -> (B, T, C)."""
        d = self.in2enc(in_seq) + self.lab2enc(embedded_targets)
        raw = torch.einsum("bte,ble->btl", d, enc_seq)
        attns = raw / raw.sum(dim=2, keepdim=True)   # sum-normalized, as the reference
        return self.enc2in(torch.einsum("btl,ble->bte", attns, enc_seq))


class _Layer(nn.Module):
    def __init__(self, kw: int, cin: int, cout: int, E: int, enc: int, norm: bool, device):
        super().__init__()
        self.input_residual = Linear(E, cout, device=device)
        self.conv_glu = CausalConv1d(cin, cout, kw, w_init=xavier_normal, device=device)
        self.conv_id = CausalConv1d(cin, cout, kw, w_init=xavier_normal, device=device)
        self.block_residual = Linear(cin, cout, device=device)
        self.attn = _Attention(cout, E, enc, device)
        if norm:
            self.norm = LayerNorm(cin, device=device)

    def reset_parameters(self, generator):
        for m in (self.input_residual, self.conv_glu, self.conv_id, self.block_residual,
                  self.attn):
            m.reset_parameters(generator)
        if hasattr(self, "norm"):
            self.norm.reset_parameters()

    def forward(self, conv_seq, emb, encoding):
        if hasattr(self, "norm"):
            conv_seq = self.norm(conv_seq)
        block = glu(self.conv_glu(conv_seq), self.conv_id(conv_seq)) \
            + self.block_residual(conv_seq)
        conv_seq = block + self.input_residual(emb)
        return conv_seq + self.attn(conv_seq, encoding, emb)


class AttnConvolutionalDecoder(nn.Module):
    """layers: [(kwidth, in_channels, out_channels)]; embed_dim must equal
    layers[0][1] (reference conv_decoder.py:105)."""

    def __init__(self, num_labels: int, embed_dim: int, layers: Sequence[Tuple[int, int, int]],
                 encoding_dim: int, max_time: int, norm: bool = False, *, device=None):
        super().__init__()
        self.layers = tuple(tuple(l) for l in layers)
        if embed_dim != self.layers[0][1]:
            raise ValueError(f"embed_dim {embed_dim} != the first layer's in_channels "
                             f"{self.layers[0][1]}")
        self.max_time = max_time
        E = embed_dim
        self.label_embed = nn.Parameter(torch.empty((num_labels, E), device=device))
        self.time_embed = nn.Parameter(torch.empty((max_time, E), device=device))
        self.output_residual = Linear(E, num_labels, device=device)
        self.output_proj = Linear(self.layers[-1][2], num_labels, device=device)
        for i, (kw, cin, cout) in enumerate(self.layers):
            self.add_module(f"layer{i}", _Layer(kw, cin, cout, E, encoding_dim, norm, device))

    def _layers(self):
        return [getattr(self, f"layer{i}") for i in range(len(self.layers))]

    def reset_parameters(self, generator: Optional[torch.Generator]):
        """JAX's init order (conv_decoder.py:52-86): xavier-normal weights,
        zero biases."""
        with torch.no_grad():
            for p in (self.label_embed, self.time_embed):
                p.copy_(xavier_normal(tuple(p.shape), generator))
        for m in (self.output_residual, self.output_proj, *self._layers()):
            m.reset_parameters(generator)

    def forward(self, encoding, targets):
        """Teacher-forced forward (conv_decoder.py:165-208): encoding (B, Le,
        encoding_dim), targets (B, max_time) int -> (B, max_time,
        num_labels) unnormalized logits."""
        T = targets.shape[1]
        if T != self.max_time:
            raise ValueError(f"targets of {T} steps, the decoder's max_time is {self.max_time}")
        emb = self.label_embed[targets.long()] + self.time_embed[:T][None]
        conv_seq = emb
        for layer in self._layers():
            conv_seq = layer(conv_seq, emb, encoding)
        return self.output_proj(conv_seq) + self.output_residual(emb)
