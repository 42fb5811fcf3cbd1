"""Reprojection residuals with analytic Jacobians (counterpart of
`monocular_slam_tpu/optim/residuals.py`): r = pi(K, T X) - uv, the 2x6 pose
Jacobian for the left twist update exp(xi) T and the 2x3 point Jacobian."""

from __future__ import annotations

import torch

from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.geometry.so3 import hat

_EPS = 1e-8


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < _EPS, torch.where(z < 0, -_EPS, _EPS).to(z.dtype), z)


def project_point(T, X, k):
    """(Xc (..., 3) camera-frame point, uv_hat (..., 2) its projection)."""
    Xc = se3.apply(T, X)
    z = _safe_z(Xc[..., 2])
    u = k[..., 0] * Xc[..., 0] / z + k[..., 2]
    v = k[..., 1] * Xc[..., 1] / z + k[..., 3]
    return Xc, torch.stack([u, v], dim=-1)


def residual(T, X, k, uv) -> torch.Tensor:
    return project_point(T, X, k)[1] - uv


def chi2(r: torch.Tensor, info: torch.Tensor | None = None) -> torch.Tensor:
    """Squared error per edge, times its scalar information weight."""
    e2 = (r * r).sum(-1)
    return e2 if info is None else e2 * info


def _small_mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) as broadcast multiply + sum over k."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def linearize(T, X, k, uv):
    """(r (..., 2), Jp (..., 2, 6), Jl (..., 2, 3))."""
    Xc = se3.apply(T, X)
    z = _safe_z(Xc[..., 2])
    u = k[..., 0] * Xc[..., 0] / z + k[..., 2]
    v = k[..., 1] * Xc[..., 1] / z + k[..., 3]
    r = torch.stack([u, v], dim=-1) - uv

    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = k[..., 0], k[..., 1]
    zero = torch.zeros_like(Xc[..., 0])
    fx, fy = fx + zero, fy + zero
    A = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * Xc[..., 0] * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * Xc[..., 1] * iz2], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape + (3,))
    dXc_dxi = torch.cat([-hat(Xc), eye], dim=-1)
    Jp = _small_mm(A, dXc_dxi)
    Jl = _small_mm(A, se3.rotation(T).expand(Xc.shape[:-1] + (3, 3)))
    return r, Jp, Jl
