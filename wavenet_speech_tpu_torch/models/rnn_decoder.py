"""RNN ByteNet-style decoder (wavenet_speech_tpu/models/rnn_decoder.py;
reference modules/rnn_decoder.py:13-228): ``StackedLSTMCell`` (LSTM cells,
FC/ELU links between layers, residual adds, per-layer skip projections
summed) and ``RNNByteNetDecoder`` with its ``unfold`` loop.

``lstm_cell`` is torch.nn.LSTMCell's arithmetic (gates = W_ih x + b_ih +
W_hh h + b_hh, split [i, f, g, o]). The dense layers here keep the JAX
tree's layout, which is torch's ``nn.Linear``'s: ``w`` is (out, in) and
the layer computes x @ w.T + b (rnn_decoder.py:129-135), so a JAX tree
flattened with "." is the state dict (``bridge.decoder_from_jax``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.utils.device import resolve_device

Shape = Tuple[int, ...]


def xavier_normal(shape: Shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch.nn.init.xavier_normal_: N(0, sqrt(2 / (fan_in + fan_out))).
    A 2-D (out, in) dense weight has fan_in = in, fan_out = out; a 3-D
    (kw, c_in, c_out) conv kernel fan_in = c_in * kw, fan_out = c_out * kw."""
    if len(shape) == 3:
        kw, cin, cout = shape
        fan_in, fan_out = cin * kw, cout * kw
    elif len(shape) == 2:
        fan_in, fan_out = shape[-1], shape[-2]
    else:
        fan_in = fan_out = shape[-1]
    return (2.0 / (fan_in + fan_out)) ** 0.5 * torch.randn(shape, generator=generator)


def lstm_cell(p: Mapping[str, torch.Tensor], x, h, c):
    """torch's LSTMCell step: (h', c'). p holds w_ih (4H, X), w_hh (4H, H),
    b_ih, b_hh (4H,); gate order [i, f, g, o]."""
    gates = x @ p["w_ih"].T + p["b_ih"] + h @ p["w_hh"].T + p["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


class Linear(nn.Module):
    """x @ w.T + b with w (out, in), the JAX decoders' dense layout."""

    def __init__(self, in_features: int, out_features: int, *, w_init=xavier_normal,
                 b_init=init.zeros, device=None):
        super().__init__()
        self.w_init, self.b_init = w_init, b_init
        self.w = nn.Parameter(torch.empty((out_features, in_features), device=device))
        self.b = nn.Parameter(torch.empty((out_features,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.w.copy_(self.w_init(tuple(self.w.shape), generator))
            self.b.copy_(self.b_init(tuple(self.b.shape), generator))

    def forward(self, x):
        return x @ self.w.T + self.b


class LSTMCell(nn.Module):
    """The cell's parameters under the JAX names; forward is ``lstm_cell``."""

    def __init__(self, hidden_dim: int, *, device=None):
        super().__init__()
        H = hidden_dim
        self.w_ih = nn.Parameter(torch.empty((4 * H, H), device=device))
        self.w_hh = nn.Parameter(torch.empty((4 * H, H), device=device))
        self.b_ih = nn.Parameter(torch.empty((4 * H,), device=device))
        self.b_hh = nn.Parameter(torch.empty((4 * H,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        nz3 = init.with_noise(init.zeros, 1e-3)
        with torch.no_grad():
            for p, fn in ((self.w_ih, xavier_normal), (self.w_hh, xavier_normal),
                          (self.b_ih, nz3), (self.b_hh, nz3)):
                p.copy_(fn(tuple(p.shape), generator))

    def forward(self, x, h, c):
        return lstm_cell({"w_ih": self.w_ih, "w_hh": self.w_hh, "b_ih": self.b_ih,
                          "b_hh": self.b_hh}, x, h, c)


class _Layer(nn.Module):
    def __init__(self, H: int, device):
        super().__init__()
        self.cell = LSTMCell(H, device=device)
        self.fc = Linear(H, H, b_init=init.with_noise(init.zeros, 1e-3), device=device)
        self.skip = Linear(H, H, w_init=init.eye, b_init=init.with_noise(init.zeros, 1e-5),
                           device=device)


class StackedLSTMCell(nn.Module):
    """reference rnn_decoder.py:13-83: forward(x, h0s, c0s) -> (skip_sum,
    h1s, c1s); layer l is ``l{l}`` with ``cell``, ``fc`` and ``skip``."""

    def __init__(self, hidden_dim: int, num_layers: int, *, device=None):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        for l in range(num_layers):
            self.add_module(f"l{l}", _Layer(hidden_dim, device))

    def _layers(self):
        return [getattr(self, f"l{l}") for l in range(self.num_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for layer in self._layers():
            for m in (layer.cell, layer.fc, layer.skip):
                m.reset_parameters(generator)

    def forward(self, x, h0s, c0s):
        h1s, c1s, outs, out = [], [], [], x
        for layer, h0, c0 in zip(self._layers(), h0s, c0s):
            h1, c1 = layer.cell(out, h0, c0)
            out = nn.functional.elu(layer.fc(h1)) + out
            h1s.append(h1)
            c1s.append(c1)
            outs.append(layer.skip(out))
        return sum(outs), h1s, c1s


class RNNByteNetDecoder(nn.Module):
    """reference rnn_decoder.py:86-228. ``forward`` is JAX's ``apply``, one
    decode step; ``unfold`` the autoregressive loop."""

    def __init__(self, num_labels: int, encoding_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, pad: int = 0, start: int = 5, stop: int = 6,
                 max_timesteps: int = 500, *, device=None):
        super().__init__()
        E, H, O = encoding_dim, hidden_dim, out_dim
        self.num_labels, self.hidden_dim, self.num_layers = num_labels, H, num_layers
        self.pad, self.start, self.stop, self.max_timesteps = pad, start, stop, max_timesteps
        nz = init.with_noise(init.zeros, 1e-4)
        lin = lambda i, o: Linear(i, o, b_init=nz, device=device)
        self.embed = nn.Parameter(torch.empty((num_labels, E), device=device))
        self.input_fc = lin(E, H)
        self.enc_fc1 = lin(E, E)
        self.enc_fc2 = lin(E, H)
        self.lstm = StackedLSTMCell(H, num_layers, device=device)
        self.out_fc1 = lin(H, O)
        self.out_fc2 = lin(O, num_labels)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.embed.copy_(xavier_normal(tuple(self.embed.shape), generator))
        for m in (self.input_fc, self.enc_fc1, self.enc_fc2, self.lstm, self.out_fc1,
                  self.out_fc2):
            m.reset_parameters(generator)

    def forward(self, x0, hvals, cvals, enc_step):
        """One decode step (reference rnn_decoder.py:150-182): x0 (B,) int
        labels, enc_step (B, E) -> (logits (B, num_labels), hvals, cvals)."""
        inp = self.input_fc(self.embed[x0.long()])
        e = self.enc_fc2(nn.functional.elu(self.enc_fc1(enc_step)))
        out, hvals, cvals = self.lstm(inp + e, hvals, cvals)
        out = self.out_fc2(nn.functional.elu(self.out_fc1(out)))
        return out, hvals, cvals

    @torch.no_grad()
    def unfold(self, encoding_seq, generator: Optional[torch.Generator] = None):
        """Autoregressive decode (reference rnn_decoder.py:184-228) of
        encoding_seq (B, L, E), on its device: from <START>, argmax
        feedback, <STOP> bookkeeping as ``ByteNetDecoder.generate``, for
        max_timesteps steps; the encoding is zero past L.

        The hidden and cell states start at 0.001 * N(0, 1) drawn from
        ``generator`` (each layer's h, then each layer's c), as the
        reference's, else at zero. Returns (logits (B, T, num_labels),
        lengths (B,) int32)."""
        dev = resolve_device(encoding_seq.device)
        B, L, E = encoding_seq.shape
        H, N = self.hidden_dim, self.num_layers

        def state():
            if generator is None:
                return torch.zeros((B, H), device=dev)
            return 0.001 * torch.randn((B, H), generator=generator,
                                       device=generator.device).to(dev)

        hvals = [state() for _ in range(N)]
        cvals = [state() for _ in range(N)]
        label = torch.full((B,), self.start, dtype=torch.long, device=dev)
        zeros = torch.zeros((B, E), dtype=encoding_seq.dtype, device=dev)
        stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        length = torch.zeros((B,), dtype=torch.int32, device=dev)
        logits = []
        for t in range(self.max_timesteps):
            enc_step = encoding_seq[:, t] if t < L else zeros
            out, hvals, cvals = self(label, hvals, cvals, enc_step)
            label = out.argmax(dim=-1)
            stopped |= label == self.stop
            length += (~stopped).to(torch.int32)
            logits.append(out)
        return torch.stack(logits, dim=1), length
