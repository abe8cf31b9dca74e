"""Device operations (kernels, copies and sets) a traced train step: every
one the device trace holds in the traced window, over the traced steps. It
counts the launches the host must make to keep the device busy, most of
them the skip guard's and the optimizer's where those run leaf by leaf."""


def read(r):
    if r.trace is None or not r.traced.get("steps"):
        return None
    return len(r.trace.device) / r.traced["steps"]
