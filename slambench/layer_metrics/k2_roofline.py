"""K2 (`csrc/hamming_top2.cu`) in the tracked step: the least time for its
int8 operations (2 N B M 256 a launch: the frame's N features against the
B frames of the back-traverse window of N each, forward and cross-check)
at the card's int8 rate, over the profiler's device time of those
launches, in %. Only traced frames whose K2 launches are the step's own
(no closure or relocalization in the frame) count."""

from slambench.layer_metrics._frames import frontend, launch_windows
from slambench.trace import ops_in


def read(run):
    fe = frontend(run)
    per_launch = run.work.k2_ops(fe["n_features"], fe["back_traverse"], fe["n_features"])
    t_ns, ops = 0, 0
    for rec, (lo, hi) in launch_windows(run):
        d = ops_in(run.trace, lo, hi, "hamming_top2")
        if rec["other_work"] or not len(d) or rec["k2"] != len(d):
            continue
        t_ns += int(d.sum())
        ops += per_launch * len(d)
    if not ops:
        return None
    least_s = ops / run.work.peaks(run.device_name)["int8_ops_per_s"]
    return 100.0 * least_s / (t_ns * 1e-9)
