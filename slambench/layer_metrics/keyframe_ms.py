"""Mapping block: the mean device span of the window's keyframe frames
that ran no closure or relocalization (track, then fuse, local BA, cull)."""

from slambench.layer_metrics._frames import mean_span


def read(run):
    return mean_span(run.frames, lambda f: f["is_keyframe"] and not f["other_work"])
