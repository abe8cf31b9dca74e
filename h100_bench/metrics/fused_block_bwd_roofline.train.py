"""The fused block's backward (B5, csrc/fused_block_bwd.cu) against its
roofline in the traced train steps: the least time of its work
(counts/kernels.py::fused_block_bwd over every causal layer and the traced
rows) over the device time of its kernels (with the weight-plane splits
launched for them), in %."""
from h100_bench.counts.kernels import fused_block_bwd
from h100_bench.readings import FUSED_BWD, fused_roofline


def read(r):
    return fused_roofline(r, fused_block_bwd, FUSED_BWD)
