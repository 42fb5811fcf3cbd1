"""Tracking: the mean device span (CUDA events around `add_frame`) of the
window's tracked frames that made no keyframe and ran no closure or
relocalization: the front end and the tracker in the step's programs."""

from slambench.layer_metrics._frames import mean_span


def read(run):
    return mean_span(run.frames, lambda f: f["tracked"] and not f["is_keyframe"]
                     and not f["other_work"])
