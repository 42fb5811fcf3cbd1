"""Cross-implementation trajectory comparison harness.

Replaces the reference's eyeball comparison tools — `compareORBSLAM.cpp`
(replays ORB-SLAM2 CSV exports through the PCL viewer) and
`visualiseERL.cpp` — with quantitative comparison of any two TUM-format
trajectories: timestamp association, Sim(3) alignment, ATE/RPE, and an
overlay plot. Counterpart of `monocular_slam_tpu/eval/compare.py`.

    python -m monocular_slam_tpu_torch.eval.compare ours.txt orbslam.txt --plot cmp.png
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from monocular_slam_tpu_torch.eval import ate as ate_mod
from monocular_slam_tpu_torch.io import trajectory as traj_io


def associate_trajectories(ts_a, poses_a, ts_b, poses_b, max_dt: float = 0.02):
    """Pair poses by nearest timestamps (TUM benchmark association)."""
    ia, ib = [], []
    j = 0
    order = np.argsort(ts_b)
    ts_b_sorted = ts_b[order]
    for i, t in enumerate(ts_a):
        j = np.searchsorted(ts_b_sorted, t)
        cands = [c for c in (j - 1, j) if 0 <= c < len(ts_b_sorted)]
        if not cands:
            continue
        c = min(cands, key=lambda c: abs(ts_b_sorted[c] - t))
        if abs(ts_b_sorted[c] - t) <= max_dt:
            ia.append(i)
            ib.append(order[c])
    return np.asarray(ia, int), np.asarray(ib, int)


def compare(path_a: str, path_b: str, max_dt: float = 0.02):
    """Returns a dict of comparison metrics between two TUM trajectory files."""
    ts_a, poses_a = traj_io.read_tum(path_a)
    ts_b, poses_b = traj_io.read_tum(path_b)
    ia, ib = associate_trajectories(ts_a, poses_a, ts_b, poses_b, max_dt)
    if len(ia) < 3:
        return {"error": "fewer than 3 associated poses", "n_associated": int(len(ia))}
    r = ate_mod.ate(poses_a[ia], poses_b[ib])
    return {
        "n_associated": int(len(ia)),
        "ate_rmse": float(r.rmse),
        "ate_mean": float(r.mean),
        "ate_median": float(r.median),
        "scale": float(r.scale),
        "rpe": float(ate_mod.rpe(poses_a[ia], poses_b[ib])),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trajectory_a")
    p.add_argument("trajectory_b")
    p.add_argument("--max-dt", type=float, default=0.02)
    p.add_argument("--plot", default=None)
    args = p.parse_args(argv)
    result = compare(args.trajectory_a, args.trajectory_b, args.max_dt)
    if args.plot and "error" not in result:
        ts_a, poses_a = traj_io.read_tum(args.trajectory_a)
        ts_b, poses_b = traj_io.read_tum(args.trajectory_b)
        ia, ib = associate_trajectories(ts_a, poses_a, ts_b, poses_b, args.max_dt)
        from monocular_slam_tpu_torch.viz import plots

        plots.plot_trajectory(args.plot, poses_a[ia], None, poses_b[ib])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
