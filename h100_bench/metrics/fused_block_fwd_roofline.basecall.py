"""The fused block's forward (B4, csrc/fused_block.cu) against its roofline
in the traced basecall calls: the least time of its work over the reads'
true samples (counts/kernels.py::fused_block_fwd over every causal layer)
over the device time of its kernels (with the weight-plane splits launched
for them), in %."""
from h100_bench.counts.kernels import fused_block_fwd
from h100_bench.readings import FUSED_FWD, fused_roofline


def read(r):
    return fused_roofline(r, fused_block_fwd, FUSED_FWD)
