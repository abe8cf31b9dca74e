"""Forward FLOPs of the wavenet_ctc family: the entry conv, the causal
blocks and the output stack on every sample; the classifier's input block,
centred blocks and output stack on every pooled frame."""
from __future__ import annotations

from h100_bench.counts.model import block_frame
from h100_bench.reference.wavenet_ctc import layers


def read_flops(cfg, L: int) -> float:
    m = cfg["model"]
    b, c = m["base"], m["classifier"]
    wl, cl = layers(cfg)
    out, cout = b["out_dim"], c["out_dim"]
    base = 2.0 * b["entry_kwidth"] * b["signal_dim"] * wl[0][0]
    base += sum(block_frame(ci, co, k, out) for ci, co, k, _ in wl)
    base += 2.0 * 2 * out * out
    head = block_frame(c["in_dim"], cl[0][0], 2, cout)
    head += sum(block_frame(ci, co, k, cout) for ci, co, k, _ in cl)
    head += 2.0 * (cout * cout + cout * c["num_labels"])
    return base * L + head * (L // c["downsample"])


def causal_layers(cfg):
    return layers(cfg)[0]
