"""Helpers shared by the readers (not a metric)."""

from __future__ import annotations

import numpy as np


def mean_span(frames, keep) -> float | None:
    """Mean `span_ms` of the frames that `keep` selects, None if none."""
    spans = [f["span_ms"] for f in frames if f["span_ms"] is not None and keep(f)]
    return float(np.mean(spans)) if spans else None


def traced(run):
    """(record, (lo, hi) ns) of each traced frame, in order."""
    tr = run.trace
    if tr is None or not len(tr.frames):
        return []
    return list(zip(run.traced, [tuple(x) for x in tr.frames.tolist()]))


def launch_windows(run):
    """(record, (lo, hi) ns) of each traced frame for finding the kernels it
    launched: from the previous traced frame's end (the first frame: the
    median gap between traced frames before its start) to its own end. In
    the profiler's trace the device's clock drifts from the host's (by up to
    1.5 ms a second in traced runs on an H100), so a kernel launched early
    in a frame can read as starting before the frame's host span; between
    frames the card idles while the host waits for the next due frame, and
    a frame's own launches of a kernel come well before its end, so the
    wider start takes in no other frame's."""
    frames = traced(run)
    if not frames:
        return []
    spans = np.array([span for _, span in frames], np.int64)
    gap = int(np.median(spans[1:, 0] - spans[:-1, 1])) if len(spans) > 1 else 0
    starts = np.concatenate([[spans[0, 0] - max(gap, 0)], spans[:-1, 1]])
    return [(rec, (int(lo), int(hi))) for (rec, _), lo, hi in zip(frames, starts, spans[:, 1])]


def frontend(run) -> dict:
    """The configuration's image size and extractor settings."""
    slam = run.config["slam"]
    fe = slam.get("frontend", {})
    return {"hw": (int(slam["image_wh"][1]), int(slam["image_wh"][0])),
            "n_features": int(fe.get("n_features", 1000)), "n_levels": int(fe.get("n_levels", 8)),
            "back_traverse": int(slam.get("track", {}).get("back_traverse", 5))}
