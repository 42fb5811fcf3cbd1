"""SO(3): exp/log, quaternions (counterpart of `monocular_slam_tpu/geometry/so3.py`).

Branch-free (`torch.where` with Taylor fallbacks), batched over leading
dims. Rotation matrices are world->camera; quaternions are (x, y, z, w).
"""

from __future__ import annotations

import torch

from monocular_slam_tpu_torch.ops import small_eigh
from monocular_slam_tpu_torch.utils.linalg import det3x3

_EPS = 1e-8


def _small_thresh(dtype) -> float:
    """Angle^2 below which Taylor series replace the trig ratios."""
    return float(torch.finfo(dtype).eps) ** 0.5


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _small_thresh(w.dtype)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS),
    )
    W = hat(w)
    return _eye(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3); stable near 0 and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = vee(R - R.transpose(-1, -2))
    tiny = torch.finfo(R.dtype).tiny
    sin_t = 0.5 * torch.sqrt((antisym * antisym).sum(-1) + tiny)
    theta = torch.atan2(sin_t, cos_t)

    small = sin_t.abs() < _EPS
    factor = torch.where(
        small, 0.5 + theta * theta / 12.0,
        theta / torch.where(small, torch.ones_like(sin_t), 2.0 * sin_t),
    )
    w_generic = factor[..., None] * antisym

    near_pi = cos_t < -0.9
    one_minus_cos = torch.clamp(1.0 - cos_t, min=_EPS)
    sym = 0.5 * (R + R.transpose(-1, -2))
    N = (sym - cos_t[..., None, None] * _eye(R)) / one_minus_cos[..., None, None]
    diag = torch.stack([N[..., 0, 0], N[..., 1, 1], N[..., 2, 2]], dim=-1)
    kk = torch.argmax(diag, dim=-1)
    col = torch.gather(
        N, -1, kk[..., None, None].expand(*N.shape[:-1], 1)
    )[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where((axis * antisym).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> quaternion (x, y, z, w), best-conditioned Shepperd
    candidate, canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def ssqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS * _EPS))

    s0 = ssqrt(1.0 + tr) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = ssqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = ssqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = ssqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (Frobenius) via SVD, det = +1 enforced. On a card
    the SVD is K3's (`ops/small_eigh.svd3`) and the determinant the closed
    form, neither of which waits on the host."""
    U, _, Vt = small_eigh.svd3(M)
    return rotation_from_svd(U, Vt)


def rotation_from_svd(U: torch.Tensor, Vt: torch.Tensor) -> torch.Tensor:
    """`project_to_so3` from the factors U, Vt of its matrix's SVD: U D Vt
    with D = diag(1, 1, det(U Vt))."""
    det = det3x3(U @ Vt) if U.is_cuda else torch.linalg.det(U @ Vt)
    D = torch.ones(U.shape[:-2] + (3,), dtype=U.dtype, device=U.device)
    D = torch.cat([D[..., :2], det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt
