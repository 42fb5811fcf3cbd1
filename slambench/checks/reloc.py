"""Relocalization: where the session stands once it has got its pose back
after losing track.

A recovery is a tracked window frame r whose previous window frame was not
tracked (`check.recoveries`); its pose is the one the host read right
after `add_frame` returned, the pose the user got. A frame f is judged
against m, the tracked window frame before r, itself no recovery, whose
true rotation lies nearest f's: the error is |R_f R_m^T - G_f G_m^T|_F /
sqrt(2) in mrad, R the program's rotations and G the course's. Both poses
live in one map and their true relative rotation is small, so neither the
map's drift nor its scale enters; a relocalization into a wrong place, or
into a copy of the map that tracking built at a wrong pose, reads the
whole offset. A recovery with no such m in the window is not judged.

- `reloc_map_mrad_p50`: the median over the recoveries and the tracked
  frames among the `FOLLOW` after each: the relocalized pose and the poses
  that tracking chains from it, against the earlier sweeps' map.
- `reloc_rot_mrad_p50`, `reloc_rot_mrad_max`: the median and the largest
  error of the recoveries alone (inf with none). The port's relocalized
  pose lies a few mrad off and the next tracked frame pulls it back, as far
  as bfloat16 moves a pose, so these are read and logged, not limited
  (`PERF.md`).
"""

from __future__ import annotations

import numpy as np

from slambench.check import recoveries

FOLLOW = 10  # frames after a recovery: a third of a second at 30 Hz


def errors_mrad(poses: np.ndarray, gt: np.ndarray, tracked, follow: int = 0) -> np.ndarray:
    """The error of each recovery and of the tracked frames among the
    `follow` after it, in mrad, in window order."""
    tracked = np.asarray(tracked, bool)
    R = np.asarray(poses, np.float64)[:, :, :3]
    G = np.asarray(gt, np.float64)[:, :, :3]
    rec = recoveries(tracked)
    plain = tracked.copy()
    plain[rec] = False
    errs = []
    for r in rec:
        pool = np.flatnonzero(plain[:r])
        if not len(pool):
            continue
        for f in range(r, min(r + follow + 1, len(tracked))):
            if not tracked[f]:
                continue
            rel_gt = G[f] @ np.swapaxes(G[pool], 1, 2)
            m = pool[np.argmin(np.linalg.norm(rel_gt - np.eye(3), axis=(1, 2)))]
            diff = R[f] @ R[m].T - G[f] @ G[m].T
            errs.append(np.linalg.norm(diff) / np.sqrt(2.0) * 1e3)
    return np.asarray(errs)


def numbers(ans, gt, collected, traffic, control) -> dict:
    after = errors_mrad(ans["poses"], gt, ans["tracked"], FOLLOW)
    own = errors_mrad(ans["poses"], gt, ans["tracked"])
    inf = float("inf")
    return {"reloc_map_mrad_p50": float(np.median(after)) if len(after) else inf,
            "reloc_rot_mrad_p50": float(np.median(own)) if len(own) else inf,
            "reloc_rot_mrad_max": float(own.max()) if len(own) else inf}
