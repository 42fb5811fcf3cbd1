"""Plain float64 NumPy radial-tangential ("radtan") lens, in OpenCV's order
(k1, k2, p1, p2, k3): the model a configuration's `camera` block
publishes. The course renders through it (`slambench/course.py`) and
`correct` judges keypoints in its undistorted pixels (`slambench/check.py`).

The inverse is the fixed-point iteration that OpenCV's `undistortPoints`
and the port run, carried on until the largest step is under `TOL`.
"""

from __future__ import annotations

import numpy as np

KEYS = ("k1", "k2", "p1", "p2", "k3")
TOL = 1e-14  # normalized units: 4.6e-12 px at EuRoC's fx
MAX_ITER = 100


def coefficients(camera: dict) -> np.ndarray | None:
    """(5,) float64 (k1, k2, p1, p2, k3) of a configuration's `camera`
    block, or None when every coefficient is zero (a pinhole)."""
    dist = np.array([float(camera.get(key, 0.0)) for key in KEYS], np.float64)
    return dist if np.any(dist != 0.0) else None


def _terms(dist, x, y):
    k1, k2, p1, p2, k3 = (float(c) for c in dist)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return radial, tx, ty


def distort(dist, xy: np.ndarray) -> np.ndarray:
    """(..., 2) undistorted normalized coordinates -> distorted ones."""
    xy = np.asarray(xy, np.float64)
    x, y = xy[..., 0], xy[..., 1]
    radial, tx, ty = _terms(dist, x, y)
    return np.stack([x * radial + tx, y * radial + ty], axis=-1)


def undistort(dist, xy_d: np.ndarray, iters: int | None = None):
    """(xy, iterations, largest last step): the (..., 2) undistorted
    normalized coordinates of distorted ones, by x <- (x_d - t(x)) /
    radial(x) from x = x_d. With `iters` None the iteration runs until its
    largest step is under `TOL` (and fails if `MAX_ITER` do not get
    there); otherwise exactly `iters` times."""
    xy_d = np.asarray(xy_d, np.float64)
    xy, step = xy_d, np.inf
    for n in range(1, (iters or MAX_ITER) + 1):
        radial, tx, ty = _terms(dist, xy[..., 0], xy[..., 1])
        new = np.stack([(xy_d[..., 0] - tx) / radial, (xy_d[..., 1] - ty) / radial], axis=-1)
        step = float(np.abs(new - xy).max(initial=0.0))
        xy = new
        if iters is None and step < TOL:
            return xy, n, step
    if iters is None:
        raise ValueError(f"radtan inverse not converged after {MAX_ITER} steps: {step}")
    return xy, iters, step


def undistort_pixels(k, dist, uv: np.ndarray) -> np.ndarray:
    """(..., 2) distorted pixels -> undistorted pixels under intrinsics k =
    (fx, fy, cx, cy), converged (the port's `undistort_pixels` convention:
    normalized x = (u - cx) / fx)."""
    k = np.asarray(k, np.float64)
    uv = np.asarray(uv, np.float64)
    xy_d = np.stack([(uv[..., 0] - k[2]) / k[0], (uv[..., 1] - k[3]) / k[1]], axis=-1)
    xy = undistort(dist, xy_d)[0]
    return np.stack([xy[..., 0] * k[0] + k[2], xy[..., 1] * k[1] + k[3]], axis=-1)
