"""DLT triangulation, batched over points (counterpart of
`monocular_slam_tpu/geometry/triangulate.py`). The (..., 4, 4) normal
matrices are decomposed by K3 (`ops/small_eigh.py`) on a card and by
`torch.linalg.eigh` on the CPU."""

from __future__ import annotations

import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.ops import small_eigh
from monocular_slam_tpu_torch.utils.linalg import gram

_EPS = 1e-12


def projection_matrix(k: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """P = K [R | t]."""
    return cam.intrinsics_to_matrix(k) @ T


def triangulate_dlt(P1, P2, uv1, uv2) -> torch.Tensor:
    """Two-view DLT. P: (..., 3, 4); uv: (..., N, 2) -> (..., N, 3)."""

    def rows(P, uv):
        P = P[..., None, :, :]
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        return u * P[..., 2, :] - P[..., 0, :], v * P[..., 2, :] - P[..., 1, :]

    a0, a1 = rows(P1, uv1)
    a2, a3 = rows(P2, uv2)
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)  # (..., N, 4, 4)
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=_EPS)
    _, V = small_eigh.eigh(gram(A))  # K3 on a card
    Xh = V[..., :, 0]
    w = Xh[..., 3]
    w_safe = torch.where(w.abs() < _EPS, torch.where(w < 0, -_EPS, _EPS).to(w.dtype), w)
    return Xh[..., :3] / w_safe[..., None]


def triangulate_two_view(k1, T1, k2, T2, uv1, uv2) -> torch.Tensor:
    return triangulate_dlt(projection_matrix(k1, T1), projection_matrix(k2, T2), uv1, uv2)


def depths(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    return (R[..., None, 2, :] * X).sum(-1) + t[..., 2:3]


def reprojection_error(k: torch.Tensor, T: torch.Tensor, X: torch.Tensor,
                       uv: torch.Tensor) -> torch.Tensor:
    """Per-point pixel reprojection error norm of world points X under the
    pose T (a batch of poses broadcasts over a point axis)."""
    proj = cam.project(k, se3.apply(T[..., None, :, :] if T.dim() == X.dim() else T, X))
    return torch.linalg.norm(proj - uv, dim=-1)


def parallax_cosine(T1, T2, X) -> torch.Tensor:
    c1 = se3.camera_center(T1)[..., None, :]
    c2 = se3.camera_center(T2)[..., None, :]
    r1 = X - c1
    r2 = X - c2
    num = (r1 * r2).sum(-1)
    den = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
    return num / torch.clamp(den, min=_EPS)
