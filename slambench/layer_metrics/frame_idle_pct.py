"""Device: the share of the traced frames' host spans (from `add_frame`'s
call to the pose on the host) in which no device operation ran, in %. The
wait for the next due frame lies outside the spans; the profiler's own
host work (`trace.PROFILER_OWN`) is left out of the spans."""

from slambench.layer_metrics._frames import traced
from slambench.trace import idle_ns


def read(run):
    frames = traced(run)
    if not frames:
        return None
    gaps = [idle_ns(run.trace, lo, hi) for _, (lo, hi) in frames]
    span = sum(hi - lo for _, (lo, hi) in frames) - sum(own for _, own in gaps)
    return 100.0 * sum(idle for idle, _ in gaps) / span if span > 0 else None
