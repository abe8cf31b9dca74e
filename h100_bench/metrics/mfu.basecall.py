"""Model FLOPs utilisation of the basecall window: the forward FLOPs of
every read answered (counts/model.py, at its true length), over the
window's seconds and the chip's peak for the configuration's dtype."""
from h100_bench.readings import mfu


def read(r):
    return mfu(r)
