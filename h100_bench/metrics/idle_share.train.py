"""Share of the traced train steps in which the device ran nothing, in %."""
from h100_bench.readings import idle_share


def read(r):
    return idle_share(r)
