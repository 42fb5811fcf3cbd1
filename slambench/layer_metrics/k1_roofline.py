"""K1 (`csrc/fast_score.cu`): the least time for its bytes (12 a pixel over
every pyramid level of the frame, at the card's HBM rate) over the
profiler's device time of its launches in the traced frames, in %."""

from slambench.layer_metrics._frames import frontend, traced
from slambench.trace import ops_in


def read(run):
    frames = traced(run)
    if not frames:
        return None
    fe = frontend(run)
    t_ns, n = 0, 0
    for _, (lo, hi) in frames:
        d = ops_in(run.trace, lo, hi, "corner_maps_levels")
        t_ns += int(d.sum())
        n += len(d)
    if not n:
        return None
    least_s = n * run.work.k1_bytes(fe["hw"], fe["n_levels"]) / run.work.peaks(
        run.device_name)["hbm_bytes_per_s"]
    return 100.0 * least_s / (t_ns * 1e-9)
