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


def frontend(run) -> dict:
    """The configuration's image size and extractor settings."""
    slam = run.config["slam"]
    fe = slam.get("frontend", {})
    return {"hw": (int(slam["image_wh"][1]), int(slam["image_wh"][0])),
            "n_features": int(fe.get("n_features", 1000)), "n_levels": int(fe.get("n_levels", 8)),
            "back_traverse": int(slam.get("track", {}).get("back_traverse", 5))}
