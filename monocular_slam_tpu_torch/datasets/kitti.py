"""KITTI odometry dataset loader (grayscale, monocular left camera).

New capability relative to the reference (BASELINE.json configs[3]: long
trajectories, 10k+ frames). Reads `sequences/NN/image_0/*.png`, `times.txt`,
`calib.txt` (P0 projection) and `poses/NN.txt` ground truth when present.
Counterpart of `monocular_slam_tpu/datasets/kitti.py`; images decode
through the port's native PNG decoder.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from monocular_slam_tpu_torch import native


@dataclass
class KittiSequence:
    image_paths: list[str]
    timestamps: np.ndarray
    k: np.ndarray  # (4,)
    poses_gt: np.ndarray | None  # (F, 3, 4) world->camera, or None

    def load_image(self, i: int) -> np.ndarray:
        """Frame i as float32 (H, W) grayscale [0, 255]."""
        return native.load_png_f32(self.image_paths[i])


def load(root: str, sequence: str = "00", start: int = 0, end: int | None = None, step: int = 1) -> KittiSequence:
    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, "image_0")
    names = sorted(os.listdir(img_dir))
    if end is None:
        end = len(names)
    names = names[start:end:step]
    paths = [os.path.join(img_dir, n) for n in names]

    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))[start:end:step]

    # calib.txt: P0 line = 3x4 projection of the left gray camera
    k = None
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("P0:"):
                P = np.array([float(v) for v in line.split()[1:]]).reshape(3, 4)
                k = np.array([P[0, 0], P[1, 1], P[0, 2], P[1, 2]])
    assert k is not None, "calib.txt missing P0"

    poses_gt = None
    pose_file = os.path.join(root, "poses", f"{sequence}.txt")
    if os.path.exists(pose_file):
        raw = np.loadtxt(pose_file).reshape(-1, 3, 4)[start:end:step]
        # KITTI gives camera-to-world; convert to world->camera.
        R_cw = raw[:, :3, :3]
        C = raw[:, :3, 3]
        R_wc = np.swapaxes(R_cw, -1, -2)
        t = -np.einsum("fij,fj->fi", R_wc, C)
        poses_gt = np.concatenate([R_wc, t[..., None]], axis=-1)

    return KittiSequence(image_paths=paths, timestamps=times, k=k, poses_gt=poses_gt)
