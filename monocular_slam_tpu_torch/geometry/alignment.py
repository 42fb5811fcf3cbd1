"""3D-3D similarity alignment (Horn/Umeyama) and RANSAC, the Sim3 solver of
loop closure (counterpart of `monocular_slam_tpu/geometry/alignment.py`).

RANSAC hypotheses are one batch (3-point Horn fits), as in the reference.
The draws are the reference's, made from a host key (`epipolar._sample_indices`);
`u` takes the uniforms themselves. The Gauss-Newton polish differentiates the dual
reprojection residual with `torch.func.jacfwd`, as the reference does with
`jax.jacfwd`. On a card the 3x3 SVD of every Horn fit is K3's `svd3` and
its determinant the closed form, neither of which waits on the host, so a
Sim3 RANSAC can run inside a CUDA graph; the CPU keeps `torch.linalg`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.geometry import sim3 as sim3_mod
from monocular_slam_tpu_torch.geometry.epipolar import _sample_indices
from monocular_slam_tpu_torch.ops import small_eigh
from monocular_slam_tpu_torch.utils import autodiff
from monocular_slam_tpu_torch.utils.linalg import det3x3
from monocular_slam_tpu_torch.utils.scatter import take

_EPS = 1e-12


def horn_sim3(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor | None = None,
              with_scale: bool = True) -> torch.Tensor:
    """Weighted least-squares Sim3 S with Y ~ s R X + t. X, Y (..., N, 3);
    w (..., N) >= 0. Returns (..., 3, 5)."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=_EPS)
    mu_x = (X * wn[..., None]).sum(-2, keepdim=True)
    mu_y = (Y * wn[..., None]).sum(-2, keepdim=True)
    xc = X - mu_x
    yc = Y - mu_y
    cov = ((yc * wn[..., None])[..., :, :, None] * xc[..., :, None, :]).sum(-3)
    U, D, Vt = small_eigh.svd3(cov)
    det = det3x3(U @ Vt) if cov.is_cuda else torch.linalg.det(U @ Vt)
    S_diag = torch.cat([torch.ones(cov.shape[:-2] + (2,), dtype=X.dtype, device=X.device),
                        det[..., None]], dim=-1)
    R = (U * S_diag[..., None, :]) @ Vt
    var_x = ((xc * xc).sum(-1) * wn).sum(-1)
    if with_scale:
        s = (D * S_diag).sum(-1) / torch.clamp(var_x, min=_EPS)
    else:
        s = torch.ones(cov.shape[:-2], dtype=X.dtype, device=X.device)
    t = mu_y[..., 0, :] - s[..., None] * (R * mu_x[..., 0, None, :]).sum(-1)
    return sim3_mod.pack(R, t, s)


class Sim3RansacResult(NamedTuple):
    S: torch.Tensor  # (3, 5)
    inliers: torch.Tensor  # (N,)
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _dual_reproj_err(S, X, Y, uv_x, uv_y, k_x, k_y, T_x, T_y):
    """Reprojection errors of a Sim3 hypothesis in both frames: S(X) through
    camera y against uv_y, S^-1(Y) through camera x against uv_x. Returns
    (err_x, err_y, both depths positive)."""
    Xc_y = se3.apply(T_y, sim3_mod.apply(S, X))
    Xc_x = se3.apply(T_x, sim3_mod.apply(sim3_mod.inverse(S), Y))
    err_y = torch.linalg.norm(cam.project(k_y, Xc_y) - uv_y, dim=-1)
    err_x = torch.linalg.norm(cam.project(k_x, Xc_x) - uv_x, dim=-1)
    pos = (Xc_y[..., 2] > 1e-3) & (Xc_x[..., 2] > 1e-3)
    return err_x, err_y, pos


def ransac_sim3_reproj(key, X, Y, mask, uv_x, uv_y, k_x, k_y, T_x, T_y,
                       n_iters: int = 256, px_thresh: float = 10.0, min_inliers: int = 12,
                       polish_iters: int = 4, u=None) -> Sim3RansacResult:
    """RANSAC Sim3 from matched 3D-3D pairs, inliers gated by reprojection
    error in pixels in both frames; then a Horn refit on the winner's
    inliers, and an annealed Gauss-Newton polish (gate, half, quarter) on
    the 7-dof tangent. `u`: the (n_iters, N) RANSAC uniforms in place of
    `key`."""
    dt = X.dtype
    idx = _sample_indices(key, n_iters, 3, mask, u)
    S_h = horn_sim3(X[idx], Y[idx])
    err_x, err_y, pos = _dual_reproj_err(S_h[:, None], X[None], Y[None], uv_x[None],
                                         uv_y[None], k_x, k_y, T_x, T_y)
    inl = (err_x < px_thresh) & (err_y < px_thresh) & pos & mask[None]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    S_best = take(S_h, best)
    inliers = take(inl, best)
    best_score = take(scores, best)

    S_fit = horn_sim3(X, Y, inliers.to(dt))
    ex, ey, pos1 = _dual_reproj_err(S_fit, X, Y, uv_x, uv_y, k_x, k_y, T_x, T_y)
    inl_fit = (ex < px_thresh) & (ey < px_thresh) & pos1 & mask
    use_fit = inl_fit.sum() >= best_score
    S_best = torch.where(use_fit, S_fit, S_best)
    inliers = torch.where(use_fit, inl_fit, inliers)

    geom = (X, Y, uv_x, uv_y, k_x, k_y, T_x, T_y)

    def masked_err(S, w, *g):
        ex, ey, _ = _dual_reproj_err(S, *(g or geom))
        # mask before the multiply: a masked pair at z ~ 0 projects to inf
        return torch.where(w > 0, ex * w, 0.0), torch.where(w > 0, ey * w, 0.0)

    def resid_flat(xi, S0, w, *g):
        return torch.cat(masked_err(sim3_mod.compose(sim3_mod.exp(xi), S0), w, *g))

    def gn_rounds(S_cur, w):
        z7 = torch.zeros(7, dtype=dt, device=X.device)
        eye7 = torch.eye(7, dtype=dt, device=X.device)
        for _ in range(polish_iters):
            J = autodiff.jacfwd(resid_flat, z7, S_cur, w, *geom)
            r = resid_flat(z7, S_cur, w)
            H = J.T @ J + 1e-6 * eye7
            dxi, info = torch.linalg.solve_ex(H, -(J * r[:, None]).sum(0))
            dxi = torch.where(info == 0, dxi, float("nan"))
            S_new = sim3_mod.compose(sim3_mod.exp(dxi), S_cur)
            ex, ey = masked_err(S_new, w)
            c_new = (ex**2 + ey**2).sum()
            S_cur = torch.where(c_new < (r * r).sum(), S_new, S_cur)
        return S_cur

    S_cur = gn_rounds(S_best, inliers.to(dt))
    for anneal in (0.5, 0.25):
        ex, ey, pos2 = _dual_reproj_err(S_cur, X, Y, uv_x, uv_y, k_x, k_y, T_x, T_y)
        tight = (ex < anneal * px_thresh) & (ey < anneal * px_thresh) & pos2 & mask
        use_tight = tight.sum() >= torch.clamp(inliers.sum(), max=min_inliers)
        w2 = torch.where(use_tight, tight, (ex < px_thresh) & (ey < px_thresh) & pos2 & mask)
        S_cur = gn_rounds(S_cur, w2.to(dt))
    ex, ey, pos3 = _dual_reproj_err(S_cur, X, Y, uv_x, uv_y, k_x, k_y, T_x, T_y)
    inl2 = (ex < px_thresh) & (ey < px_thresh) & pos3 & mask
    n0 = inliers.sum()
    better = inl2.sum() >= torch.clamp((9 * n0) // 10, min=min_inliers)
    S_best = torch.where(better, S_cur, S_best)
    inliers = torch.where(better, inl2, inliers)
    n = inliers.sum()
    return Sim3RansacResult(S_best, inliers, n, n >= min_inliers)


def ransac_sim3(key, X, Y, mask, n_iters: int = 256, thresh: float = 0.1,
                min_inliers: int = 12, u=None) -> Sim3RansacResult:
    """RANSAC Sim3 from 3D-3D pairs with a Euclidean inlier gate (scene
    units) and a weighted refit. `u`: the RANSAC uniforms in place of
    `key`."""
    idx = _sample_indices(key, n_iters, 3, mask, u)
    S_h = horn_sim3(X[idx], Y[idx])
    resid = torch.linalg.norm(sim3_mod.apply(S_h[:, None], X[None]) - Y[None], dim=-1)
    inl = (resid < thresh) & mask[None]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    best_inl = take(inl, best)
    S_fit = horn_sim3(X, Y, best_inl.to(X.dtype))
    inl_fit = (torch.linalg.norm(sim3_mod.apply(S_fit, X) - Y, dim=-1) < thresh) & mask
    use_fit = inl_fit.sum() >= take(scores, best)
    S_best = torch.where(use_fit, S_fit, take(S_h, best))
    inliers = torch.where(use_fit, inl_fit, best_inl)
    n = inliers.sum()
    return Sim3RansacResult(S_best, inliers, n, n >= min_inliers)
