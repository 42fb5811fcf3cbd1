"""RGB-D depth utilities: back-projection to world clouds (counterpart of
`monocular_slam_tpu/slam/depth.py`), as tensor math on the device.

Replaces the reference's depth ingestion + visualization path
(`FrameLoader::loadDepthFileList`, `src/FrameLoader.cpp:69-95`, and
`PointCloudVisualizer::DepthToCloudRGB_{VOPose,GTPose}`,
`src/PointCloudVisualizer.cpp:411-528`) — and fixes its u/v axis swap
(row index used with cx/fx, `:437-439`, SURVEY.md 2.4).
"""

from __future__ import annotations

import numpy as np
import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.utils.device import resolve_device


def depth_to_cloud(
    depth,
    k,
    T_wc=None,
    stride: int = 4,
    min_depth: float = 0.05,
    max_depth: float = 10.0,
    device=None,
):
    """Back-project a depth image (H, W) in meters to a 3D cloud.

    Returns (points (M, 3), valid (M,)) tensors in the camera frame, or in
    world coordinates when the world->camera pose `T_wc` is given. `stride`
    subsamples the image grid (the reference subsamples too). Runs on the
    device of a `depth` tensor, else on `device` (default: the card).
    """
    dev = depth.device if torch.is_tensor(depth) else resolve_device(device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(0, H, stride, device=dev),
                            torch.arange(0, W, stride, device=dev), indexing="ij")
    d = depth[ys, xs].reshape(-1)
    uv = torch.stack([xs, ys], dim=-1).to(torch.float32).reshape(-1, 2)
    valid = (d > min_depth) & (d < max_depth) & torch.isfinite(d)
    kt = torch.as_tensor(k, dtype=torch.float32, device=dev)
    X = cam.backproject(kt, uv, d)
    if T_wc is not None:
        T = torch.as_tensor(T_wc, dtype=torch.float32, device=dev)
        X = se3.apply(se3.inverse(T), X)
    return X, valid


def colored_cloud(img, depth, k, T_wc=None, stride: int = 4, device=None):
    """(points, rgb uint8, valid) as numpy — grayscale intensity as colour."""
    X, valid = depth_to_cloud(depth, k, T_wc, stride=stride, device=device)
    g = np.asarray(img.cpu() if torch.is_tensor(img) else img)[::stride, ::stride].reshape(-1)
    rgb = np.stack([g, g, g], axis=-1).astype(np.uint8)
    return X.cpu().numpy(), rgb, valid.cpu().numpy()
