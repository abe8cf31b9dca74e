"""Forward FLOPs of the raw_ctcnet family: the featurizer, the input
block, the centred blocks and the output stack on each of the L + fk - 1
frames. It has no causal block."""
from __future__ import annotations

from h100_bench.counts.model import block_frame
from h100_bench.reference.raw_ctcnet import layers


def read_flops(cfg, L: int) -> float:
    m = cfg["model"]
    Fe, fk, out = m["num_features"], m["feature_kwidth"], m["out_dim"]
    frame = 2.0 * fk * Fe + 2.0 * Fe * Fe
    frame += block_frame(Fe, m["nhid"], m["input_kernel_size"], out)
    frame += sum(block_frame(ci, co, k, out) for ci, co, k, _ in layers(cfg))
    frame += 2.0 * (out * out + out * m["num_labels"])
    return frame * (L + fk - 1)


def causal_layers(cfg):
    return []
