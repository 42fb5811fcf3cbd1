"""Middlebury temple (multi-view stereo) loader.

Replaces the reference's `loadCameraIntrinsicsAndGTRT_middleBury`
(`src/FrameLoader.cpp:241-280`): a `*_par.txt` file lists, per image,
`name k11..k33 r11..r33 t1..t3` — per-frame intrinsics AND ground-truth
world->camera extrinsics. Counterpart of
`monocular_slam_tpu/datasets/middlebury.py`; images decode through the
port's native PNG decoder (colour as 0.299 R + 0.587 G + 0.114 B).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from monocular_slam_tpu_torch import native


@dataclass
class MiddleburySequence:
    image_paths: list[str]
    k: np.ndarray  # (F, 4) per-frame intrinsics
    poses_gt: np.ndarray  # (F, 3, 4) world->camera

    def load_image(self, i: int) -> np.ndarray:
        """Frame i as float32 (H, W) grayscale [0, 255]."""
        return native.load_png_f32(self.image_paths[i])


def load(root: str, start: int = 0, end: int | None = None, step: int = 1) -> MiddleburySequence:
    par = [f for f in os.listdir(root) if f.endswith("_par.txt")]
    assert par, f"no *_par.txt in {root}"
    paths, ks, poses = [], [], []
    with open(os.path.join(root, par[0])) as f:
        n = int(f.readline())
        for _ in range(n):
            vals = f.readline().split()
            name = vals[0]
            nums = np.array([float(v) for v in vals[1:]])
            K = nums[0:9].reshape(3, 3)
            R = nums[9:18].reshape(3, 3)
            t = nums[18:21]
            paths.append(os.path.join(root, name))
            ks.append([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
            poses.append(np.concatenate([R, t[:, None]], axis=1))
    sl = slice(start, end, step)
    return MiddleburySequence(
        image_paths=paths[sl],
        k=np.asarray(ks)[sl],
        poses_gt=np.asarray(poses)[sl],
    )
