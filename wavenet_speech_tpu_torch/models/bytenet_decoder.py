"""ByteNet autoregressive conv decoder (wavenet_speech_tpu/models/
bytenet_decoder.py; reference modules/bytenet_decoder.py:19-191).

Label embedding (num_labels -> 2C) -> 1x1 -> + encoding 1x1 (enc_dim ->
2C) -> causal ResidualMU / ResidualReLU blocks -> 1x1 -> ReLU -> 1x1 ->
num_labels.

``forward`` (JAX ``apply``) is the teacher-forced parallel forward;
``generate`` the autoregressive loop, one ``linear`` mini-forward over the
receptive-field window a step, with argmax feedback and the <STOP>
bookkeeping of the JAX scan (the step that emits <STOP> is not counted).
Once the encoder's frames run out, the encoding window is the pad VALUE,
as in the reference (bytenet_decoder.py:170; JAX :129-135).

Submodules and parameters carry the JAX tree's names (``embed``,
``input_1x1``, ``encoding_1x1``, ``out1``, ``out2``, ``block{i}``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from wavenet_speech_tpu_torch.models.blocks import ResidualMUBlock, ResidualReLUBlock
from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops.conv import Dense
from wavenet_speech_tpu_torch.utils.device import resolve_device

_noisy_zeros = init.with_noise(init.zeros, 1e-4)


class ByteNetDecoder(nn.Module):
    def __init__(self, num_labels: int, encoding_dim: int, channels: int, output_dim: int,
                 layers: Sequence[Tuple[int, int]], block: str = "mult", pad: int = 0,
                 start: int = 5, stop: int = 6, max_timesteps: int = 500, *, device=None):
        super().__init__()
        if block not in ("mult", "relu"):
            raise ValueError(f"block must be 'mult' or 'relu', not {block!r}")
        self.num_labels, self.layers = num_labels, tuple(tuple(l) for l in layers)
        self.pad, self.start, self.stop, self.max_timesteps = pad, start, stop, max_timesteps
        C2 = 2 * channels
        dense = lambda i, o: Dense(i, o, w_init=init.kaiming_normal, b_init=_noisy_zeros,
                                   device=device)
        self.embed = nn.Parameter(torch.empty((num_labels, C2), device=device))
        self.input_1x1 = dense(C2, C2)
        self.encoding_1x1 = dense(encoding_dim, C2)
        self.out1 = dense(C2, output_dim)
        self.out2 = dense(output_dim, num_labels)
        cls = ResidualMUBlock if block == "mult" else ResidualReLUBlock
        for i, (k, d) in enumerate(self.layers):
            self.add_module(f"block{i}", cls(C2, k, d, device=device))

    def _blocks(self):
        return [getattr(self, f"block{i}") for i in range(len(self.layers))]

    @property
    def receptive_field(self) -> int:
        """1 + sum(rf_i - 1) (reference bytenet_decoder.py:83-87)."""
        return 1 + sum(b.receptive_field - 1 for b in self._blocks())

    def reset_parameters(self, generator: Optional[torch.Generator]):
        """JAX's init order (bytenet_decoder.py:61-84); torch's
        kaiming_normal_ on the (num_labels, 2C) embedding takes fan_in =
        2C, so it is drawn (2C, num_labels) and transposed."""
        with torch.no_grad():
            C2 = self.embed.shape[1]
            self.embed.copy_(init.kaiming_normal((C2, self.num_labels), generator).T)
        for m in (self.input_1x1, self.encoding_1x1, self.out1, self.out2, *self._blocks()):
            m.reset_parameters(generator)

    def forward(self, labels, encoding):
        """Teacher-forced forward: labels (B, L) int, encoding (B, L,
        enc_dim) -> (B, L, num_labels) logits; output t depends only on
        labels and encoding at <= t."""
        o = self.input_1x1(self.embed[labels.long()])
        o = o + self.encoding_1x1(encoding)
        for blk in self._blocks():
            o = blk(o)
        return self.out2(torch.relu(self.out1(o)))

    def linear(self, dec_frames, enc_frames):
        """One step over a receptive-field window (reference
        bytenet_decoder.py:97-123): (B, num_labels) of the last frame."""
        return self(dec_frames, enc_frames)[:, -1, :]

    @torch.no_grad()
    def generate(self, encoded_seq):
        """Autoregressive decode (reference forward(), bytenet_decoder.py:
        126-191) of encoded_seq (B, L_enc, enc_dim), on its device.

        Returns (logits (B, max_timesteps, num_labels), lengths (B,) int32),
        lengths counting the steps before the first <STOP>."""
        resolve_device(encoded_seq.device)
        B, L_enc, E = encoded_seq.shape
        rf, dev = self.receptive_field, encoded_seq.device
        # [pad]*(rf-1) + [start]; the encoding with rf-1 leading zero frames
        buf = torch.full((B, rf), self.pad, dtype=torch.long, device=dev)
        buf[:, -1] = self.start
        enc_pad = nn.functional.pad(encoded_seq, (0, 0, rf - 1, 0))
        pad_window = torch.full((B, rf, E), float(self.pad), dtype=encoded_seq.dtype,
                                device=dev)
        stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        length = torch.zeros((B,), dtype=torch.int32, device=dev)
        logits = []
        for k in range(self.max_timesteps):
            window = enc_pad[:, k:k + rf] if k < L_enc else pad_window
            step = self.linear(buf, window)
            nxt = step.argmax(dim=-1)
            stopped |= nxt == self.stop
            length += (~stopped).to(torch.int32)
            buf = torch.cat([buf[:, 1:], nxt[:, None]], dim=1)
            logits.append(step)
        return torch.stack(logits, dim=1), length
