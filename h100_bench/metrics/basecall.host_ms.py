"""Host ms a traced basecall call: each call's span less the time within
it in which the device ran something (Basecaller's bucket, the copy's
host side, the strings, and launch overheads), the mean over the calls."""


def read(r):
    if r.trace is None:
        return None
    calls = [(a, b) for name, a, b in r.trace.spans if name == "bench.call"]
    if not calls or r.trace.busy_s <= 0:
        return None
    host = [(b - a) * 1e-3 - 1e3 * r.trace.busy_within(a, b) for a, b in calls]
    return sum(host) / len(host)
