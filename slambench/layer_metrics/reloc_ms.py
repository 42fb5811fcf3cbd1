"""Relocalization: the device milliseconds of the window's relocalization
programs (`reloc_scores`, the BoW scores, and each candidate's
`relocalize`: K2 match, PnP RANSAC, the `pose_gn` polish), from the
session's program calls, over the window's recoveries (tracked frames
after an untracked one). None without a recovery or without such a call
(the CPU records none)."""

from slambench.check import recoveries

KINDS = ("reloc_scores", "relocalize")


def read(run):
    n = len(recoveries([f["tracked"] for f in run.frames]))
    ms = [c["ms"] for c in run.calls if c["kind"] in KINDS]
    return sum(ms) / n if n and ms else None
