"""Perspective-n-Point: batched DLT minimal solver + LO-RANSAC + GN polish
(counterpart of `monocular_slam_tpu/geometry/pnp.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3, so3
from monocular_slam_tpu_torch.geometry.epipolar import _sample_indices
from monocular_slam_tpu_torch.optim import pose_ba
from monocular_slam_tpu_torch.utils.linalg import gram, nullspace_vector, polar_orthogonalize
from monocular_slam_tpu_torch.utils.scatter import take

_EPS = 1e-12
MIN_SAMPLE = 6
LO_ROUNDS = 2  # exact weighted-DLT refits of the best hypothesis


def pnp_dlt(X, xy, w=None, solver: str = "eigh") -> torch.Tensor:
    """DLT PnP from n >= 6 points. X (..., n, 3) world; xy (..., n, 2)
    normalized coords; w (..., n) weights. Returns (..., 3, 4)."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)], dim=-1)
    zeros = torch.zeros_like(Xh)
    x, y = xy[..., 0:1], xy[..., 1:2]
    rows1 = torch.cat([Xh, zeros, -x * Xh], dim=-1)
    rows2 = torch.cat([zeros, Xh, -y * Xh], dim=-1)
    A = torch.cat([rows1 * w[..., None], rows2 * w[..., None]], dim=-2)
    p = nullspace_vector(gram(A), method=solver)
    P = p.reshape(p.shape[:-1] + (3, 4))
    depth = (P[..., None, :, :] * Xh[..., None, :]).sum(-1)[..., 2]
    sgn = torch.where((torch.sign(depth) * w).sum(-1) < 0, -1.0, 1.0).to(X.dtype)
    P = P * sgn[..., None, None]
    M = P[..., :3, :3]
    if solver == "inv_iter":
        det = torch.linalg.det(M)
        scale = torch.pow(torch.clamp(det, min=_EPS), 1.0 / 3.0)
        R = polar_orthogonalize(M / torch.clamp(scale, min=_EPS)[..., None, None])
    else:
        s = torch.linalg.svdvals(M)
        scale = s.mean(-1)
        R = so3.project_to_so3(M)
    t = P[..., :3, 3] / torch.clamp(scale, min=_EPS)[..., None]
    return se3.from_Rt(R, t)


class PnPResult(NamedTuple):
    T: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _score_pose(T, X, uv, k, mask, px_thresh):
    Xc = se3.apply(T[..., None, :, :], X)
    err2 = ((cam.project(k, Xc) - uv) ** 2).sum(-1)
    inl = (err2 < px_thresh * px_thresh) & (Xc[..., 2] > 0) & mask
    return inl, inl.sum(-1)


def solve_pnp_ransac(
    gen,
    X: torch.Tensor,
    uv: torch.Tensor,
    k: torch.Tensor,
    mask: torch.Tensor,
    n_iters: int = 512,
    px_thresh: float = 3.0,
    min_inliers: int = 10,
    T_init: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> PnPResult:
    """LO-RANSAC PnP. X (N, 3), uv (N, 2), k (4,), mask (N,). `T_init` joins
    the hypothesis pool; `u` are optional (n_iters, N) sampling uniforms."""
    xy = cam.normalize_points(k, uv)
    idx = _sample_indices(gen, n_iters, MIN_SAMPLE, mask, u)
    T_h = pnp_dlt(X[idx], xy[idx], solver="inv_iter")
    if T_init is not None:
        T_h = torch.cat([T_h, T_init[None]], dim=0)
    inl, scores = _score_pose(T_h, X[None], uv[None], k, mask[None], px_thresh)
    best = torch.argmax(scores)
    T_best = take(T_h, best)
    inl_best = take(inl, best)
    n_best = take(scores, best)

    for _ in range(LO_ROUNDS):
        wlo = (inl_best & mask).to(X.dtype)
        T_lo = pnp_dlt(X, xy, w=wlo, solver="eigh")
        inl_lo, n_lo = _score_pose(T_lo, X, uv, k, mask, px_thresh)
        use = n_lo > n_best
        T_best = torch.where(use, T_lo, T_best)
        inl_best = torch.where(use, inl_lo, inl_best)
        n_best = torch.where(use, n_lo, n_best)

    res = pose_ba.refine_pose(T_best, X, uv, k, inl_best.to(X.dtype), n_rounds=2,
                              solver="gn")
    # accept the refinement only if it keeps at least as many inliers
    use = res.n_inliers >= inl_best.sum()
    T_fin = torch.where(use, res.T, T_best)
    inl_fin = torch.where(use, res.inliers, inl_best)
    n_inl = inl_fin.sum()
    return PnPResult(T_fin, inl_fin, n_inl, n_inl >= min_inliers)
