"""Matplotlib renderings of trajectories, maps, matches, and epipolar lines
(counterpart of `monocular_slam_tpu/viz/plots.py`; matplotlib is imported
inside each function, so the package runs where it is absent).

Replaces the reference's GUI stack with offline artifacts:
  - plot_trajectory: the TrajectoryVisualizer odometry mini-map
    (`src/TrajectoryVisualizer.cpp:27-126`) as a top-down PNG with the
    ground-truth overlay its `showGroundtruthTrajectory` toggle provided;
  - plot_map: the PointCloudVisualizer map+trajectory scene
    (`src/PointCloudVisualizer.cpp:382-407`, camera glyphs :233-294);
  - draw_matches / draw_epipolar: `SFMDebugging`'s match visualizer and
    epipolar-line tool (`src/SFMDebugging.cpp:21-89`) to image files.
"""

from __future__ import annotations

import numpy as np


def _centers(poses):
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("fji,fj->fi", R, t)


def plot_trajectory(path, poses, valid=None, poses_gt=None, align=True):
    """Top-down (x-z) trajectory plot; optionally Sim3-aligned GT overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = np.asarray(poses)
    if valid is None:
        valid = np.ones(len(poses), bool)
    C = _centers(poses[valid])
    fig, ax = plt.subplots(figsize=(6, 6))
    if poses_gt is not None:
        Cg = _centers(np.asarray(poses_gt)[: len(valid)][valid])
        if align and len(C) > 2:
            from monocular_slam_tpu_torch.eval.ate import umeyama_sim3

            s, R, t = umeyama_sim3(C, Cg)
            C = (s * (R @ C.T)).T + t
        ax.plot(Cg[:, 0], Cg[:, 2], "-", color="0.6", lw=1.5, label="ground truth")
    ax.plot(C[:, 0], C[:, 2], "-", color="tab:blue", lw=1.2, label="estimate")
    ax.plot(C[0, 0], C[0, 2], "o", color="tab:green", ms=6)
    ax.plot(C[-1, 0], C[-1, 2], "s", color="tab:red", ms=6)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def plot_map(path, points, poses=None, valid=None, max_points=20000):
    """3D scatter of the map + camera trail."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 2], pts[:, 1], s=0.5, c="tab:blue", alpha=0.4)
    if poses is not None:
        poses = np.asarray(poses)
        if valid is not None:
            poses = poses[valid]
        C = _centers(poses)
        ax.plot(C[:, 0], C[:, 2], C[:, 1], "-", color="tab:red", lw=1.5)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def draw_matches(path, img1, img2, uv1, uv2, mask=None, max_draw=120):
    """Side-by-side match visualization (`visualizeFeatureMatching`,
    `src/SFMDebugging.cpp:48-73`) written to an image file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img1, img2 = np.asarray(img1), np.asarray(img2)
    h = max(img1.shape[0], img2.shape[0])
    canvas = np.zeros((h, img1.shape[1] + img2.shape[1]), np.float32)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1] :] = img2
    off = img1.shape[1]
    uv1, uv2 = np.asarray(uv1), np.asarray(uv2)
    if mask is None:
        mask = np.ones(len(uv1), bool)
    sel = np.where(mask)[0][:max_draw]
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas, cmap="gray")
    for i in sel:
        ax.plot(
            [uv1[i, 0], uv2[i, 0] + off], [uv1[i, 1], uv2[i, 1]],
            "-", lw=0.5, alpha=0.7,
        )
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_epipolar(path, img2, F, uv1, uv2=None, max_draw=30):
    """Epipolar lines of uv1 drawn on image 2 (`drawEpipolarLine`,
    `src/SFMDebugging.cpp:21-40`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img2 = np.asarray(img2)
    F = np.asarray(F)
    uv1 = np.asarray(uv1)[:max_draw]
    H, W = img2.shape[:2]
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.imshow(img2, cmap="gray")
    ones = np.ones((len(uv1), 1))
    lines = (F @ np.concatenate([uv1, ones], axis=1).T).T  # (N, 3)
    xs = np.array([0.0, W - 1.0])
    for a, b, c in lines:
        if abs(b) < 1e-9:
            continue
        ys = -(a * xs + c) / b
        ax.plot(xs, ys, "-", lw=0.6, alpha=0.8)
    if uv2 is not None:
        uv2 = np.asarray(uv2)[:max_draw]
        ax.plot(uv2[:, 0], uv2[:, 1], "r+", ms=5)
    ax.set_xlim(0, W)
    ax.set_ylim(H, 0)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
