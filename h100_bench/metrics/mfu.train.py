"""Model FLOPs utilisation of the train window: 3 x the forward FLOPs of
each step's batch (counts/model.py; no recompute), over the window's
seconds and the chip's peak for the configuration's dtype."""
from h100_bench.readings import mfu


def read(r):
    return mfu(r)
