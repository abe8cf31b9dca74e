"""The band attention's kernels (``ops/window_attention.py``) against their
roofline in the traced train steps: the least time of the band's work
(counts/bonito_transformer.py::window_attn, forward and backward, every
layer, every traced step, at the mix's batch and its padded chunk's stem
frames; peaks as ``readings.fused_roofline`` takes them) over the device
time of the kernels whose names hold ``window_attn``, in %. None where the
configuration has no band or the trace holds no such kernel."""
from h100_bench.counts.bonito_transformer import window_attn
from h100_bench.counts.kernels import least_seconds
from h100_bench.reference.bonito_transformer import stem_frames


def read(r):
    m = r.cfg.get("model", {})
    if r.trace is None or r.peaks is None or "attn_window" not in m \
            or not r.traced.get("steps"):
        return None
    seconds = r.trace.kernel_seconds(r"window_attn")
    if seconds <= 0:
        return None
    T = stem_frames(r.cfg, r.mix["pad_to"])
    flops, nbytes = window_attn(r.mix["batch"], T, m["attn_window"], m["nhead"],
                                m["d_model"] // m["nhead"])
    least = least_seconds(flops, nbytes, r.peaks["flops"][r.cfg["dtype"]],
                          r.peaks["bytes_per_s"])
    return 100.0 * least * m["depth"] * r.traced["steps"] / seconds
