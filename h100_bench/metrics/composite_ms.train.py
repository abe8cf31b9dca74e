"""Device ms a traced train step in the library's products: cuDNN's
convolutions and cuBLAS's matrix products, matched by kernel name
(readings.LIBRARY, the port's own kernels left out). In RawCTCNet they are
the centred blocks' composite (conv, 1x1, residual and bottleneck
products) and, a few per cent of the FLOPs, the featurizer and the output
stack."""
from h100_bench.readings import LIBRARY, OWN


def read(r):
    if r.trace is None or not r.traced.get("steps"):
        return None
    s = r.trace.kernel_seconds(LIBRARY, exclude=OWN)
    return 1e3 * s / r.traced["steps"] if s > 0 else None
