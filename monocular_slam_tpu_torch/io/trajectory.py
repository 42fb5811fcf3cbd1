"""TUM-format trajectory read/write (a numpy copy of
`monocular_slam_tpu/io/trajectory.py`; the port keeps its own).

Replaces the reference's eyeball visualizers (`TrajectoryVisualizer`,
`compareORBSLAM.cpp`) with the standard text interchange format:
`timestamp tx ty tz qx qy qz qw` per line, camera-to-world (the TUM
benchmark convention), so output is directly consumable by evo/TUM tools.
"""

from __future__ import annotations

import numpy as np


def _matrix_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) (x, y, z, w), numpy, Shepperd's method."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R.reshape(-1, 3, 3)).as_quat()
    return q.reshape(R.shape[:-2] + (4,))


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    R = Rotation.from_quat(q.reshape(-1, 4)).as_matrix()
    return R.reshape(q.shape[:-1] + (3, 3))


def write_tum(
    path: str,
    poses_wc: np.ndarray,
    timestamps: np.ndarray,
    valid: np.ndarray | None = None,
) -> None:
    """Write world->camera (3, 4) poses as TUM camera-to-world lines."""
    poses_wc = np.asarray(poses_wc)
    timestamps = np.asarray(timestamps)
    if valid is None:
        valid = np.ones(len(poses_wc), bool)
    R_wc = poses_wc[:, :3, :3]
    t_wc = poses_wc[:, :3, 3]
    R_cw = np.swapaxes(R_wc, -1, -2)
    C = -np.einsum("fij,fj->fi", R_cw, t_wc)  # camera centers
    q = _matrix_to_quat_np(R_cw)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(len(poses_wc)):
            if not valid[i]:
                continue
            f.write(
                f"{timestamps[i]:.6f} "
                + " ".join(f"{v:.9f}" for v in C[i])
                + " "
                + " ".join(f"{v:.9f}" for v in q[i])
                + "\n"
            )


def read_tum(path: str):
    """Read a TUM trajectory file -> (timestamps (F,), poses_wc (F, 3, 4)).

    Accepts the groundtruth.txt format of TUM RGB-D datasets
    (`loadGroundTruth` semantics, `src/FrameLoader.cpp:116-168`).
    """
    ts, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            rows.append(vals[1:8])
    ts = np.asarray(ts)
    rows = np.asarray(rows)
    C = rows[:, :3]
    q = rows[:, 3:7]  # (x, y, z, w)
    R_cw = _quat_to_matrix_np(q)
    R_wc = np.swapaxes(R_cw, -1, -2)
    t_wc = -np.einsum("fij,fj->fi", R_wc, C)
    poses = np.concatenate([R_wc, t_wc[..., None]], axis=-1)
    return ts, poses
