"""Pinhole camera: projection, normalization, radtan undistortion
(counterpart of `monocular_slam_tpu/geometry/camera.py`). Intrinsics are
(fx, fy, cx, cy) 4-vectors."""

from __future__ import annotations

import torch

_EPS = 1e-9


def intrinsics_to_matrix(k: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, z, cx], dim=-1),
            torch.stack([z, fy, cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_intrinsics(K: torch.Tensor) -> torch.Tensor:
    return torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(
        z.abs() < _EPS, torch.where(z < 0, -_EPS, _EPS).to(z.dtype), z
    )


def project(k: torch.Tensor, X_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    inv_z = 1.0 / _safe_z(X_cam[..., 2])
    u = k[..., 0] * X_cam[..., 0] * inv_z + k[..., 2]
    v = k[..., 1] * X_cam[..., 1] * inv_z + k[..., 3]
    return torch.stack([u, v], dim=-1)


def backproject(k: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depth -> (..., 3) camera-frame points."""
    x = (uv[..., 0] - k[..., 2]) / k[..., 0] * depth
    y = (uv[..., 1] - k[..., 3]) / k[..., 1] * depth
    return torch.stack([x, y, depth], dim=-1)


def normalize_points(k: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    x = (uv[..., 0] - k[..., 2]) / k[..., 0]
    y = (uv[..., 1] - k[..., 3]) / k[..., 1]
    return torch.stack([x, y], dim=-1)


def distort_radtan(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion (k1, k2, p1, p2, k3; OpenCV's order) of
    normalized coordinates."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_radtan(dist: torch.Tensor, xy_d: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Fixed-point inversion of radtan distortion (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        radial = torch.where(radial.abs() < 1e-6, torch.full_like(radial, 1e-6), radial)
        xy = torch.stack([(xy_d[..., 0] - tx) / radial, (xy_d[..., 1] - ty) / radial], dim=-1)
    return xy


def in_image(uv: torch.Tensor, width: int, height: int, margin: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] <= width - 1 - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] <= height - 1 - margin)
    )


def undistort_pixels(k: torch.Tensor, dist: torch.Tensor, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    xy_u = undistort_radtan(dist, normalize_points(k, uv), iters=iters)
    u = xy_u[..., 0] * k[..., 0] + k[..., 2]
    v = xy_u[..., 1] * k[..., 1] + k[..., 3]
    return torch.stack([u, v], dim=-1)
