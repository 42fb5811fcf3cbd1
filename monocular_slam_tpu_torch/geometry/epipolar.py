"""Two-view epipolar geometry: eight-point, Sampson, RANSAC-F, E,
cheirality (counterpart of `monocular_slam_tpu/geometry/epipolar.py`).

RANSAC hypotheses are one batch: one constraint build, one batched
nullspace solve, one Sampson evaluation, one argmax. The draws are the
reference's: `_sample_indices` makes `jax.random.uniform(key, ...)`'s
uniforms on the mask's device (`prng.uniform_on`) from a host key. Every
RANSAC entry also takes the uniforms themselves as `u` (then `key` may be
None). On a card the 3x3 SVDs (the rank-2 projection, the essential
decomposition) are K3's `svd3` and their determinants the closed form, so
the bootstrap runs inside a CUDA graph; the CPU keeps `torch.linalg`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3, triangulate
from monocular_slam_tpu_torch.ops import small_eigh
from monocular_slam_tpu_torch.utils import prng
from monocular_slam_tpu_torch.utils.linalg import det3x3, gram, nullspace_vector
from monocular_slam_tpu_torch.utils.scatter import take, topk_stable

_EPS = 1e-12


def hartley_normalize(uv: torch.Tensor, mask: torch.Tensor | None = None):
    """Zero mean, mean distance sqrt(2); masked points are ignored in the
    statistics. Returns (uv_norm, T (..., 3, 3))."""
    if mask is None:
        mask = torch.ones(uv.shape[:-1], dtype=torch.bool, device=uv.device)
    w = mask.to(uv.dtype)
    n = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (uv * w[..., None]).sum(-2, keepdim=True) / n[..., None]
    d = torch.linalg.norm(uv - mean, dim=-1)
    mean_d = (d * w).sum(-1, keepdim=True) / n
    s = 2.0**0.5 / torch.clamp(mean_d, min=_EPS)
    uv_n = (uv - mean) * s[..., None]
    zeros = torch.zeros_like(s[..., 0])
    ones = torch.ones_like(s[..., 0])
    sx = s[..., 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    T = torch.stack(
        [
            torch.stack([sx, zeros, -sx * mx], dim=-1),
            torch.stack([zeros, sx, -sx * my], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return uv_n, T


def _constraint_rows(uv1, uv2) -> torch.Tensor:
    x1, y1 = uv1[..., 0], uv1[..., 1]
    x2, y2 = uv2[..., 0], uv2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)


def eight_point(uv1, uv2, weights=None, solver: str = "eigh") -> torch.Tensor:
    """(Weighted) normalized eight-point with rank-2 projection; ||F|| = 1."""
    if weights is None:
        weights = torch.ones(uv1.shape[:-1], dtype=uv1.dtype, device=uv1.device)
    mask = weights > 0
    uv1n, T1 = hartley_normalize(uv1, mask)
    uv2n, T2 = hartley_normalize(uv2, mask)
    A = _constraint_rows(uv1n, uv2n) * weights[..., None]
    f = nullspace_vector(gram(A), method=solver)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = small_eigh.svd3(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    return F / torch.clamp(torch.linalg.norm(F, dim=(-2, -1), keepdim=True), min=_EPS)


def sampson_distance(F, uv1, uv2) -> torch.Tensor:
    ones = torch.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype, device=uv1.device)
    x1 = torch.cat([uv1, ones], dim=-1)
    x2 = torch.cat([uv2, ones], dim=-1)
    Fx1 = (F[..., None, :, :] * x1[..., None, :]).sum(-1)
    Ftx2 = (F.transpose(-1, -2)[..., None, :, :] * x2[..., None, :]).sum(-1)
    num = ((x2 * Fx1).sum(-1)) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=_EPS)


def epipolar_line(F: torch.Tensor, uv1: torch.Tensor) -> torch.Tensor:
    """Lines l2 = F x1 in image 2 as (a, b, c) with ax + by + c = 0."""
    ones = torch.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype, device=uv1.device)
    x1 = torch.cat([uv1, ones], dim=-1)
    return (F[..., None, :, :] * x1[..., None, :]).sum(-1)


class RansacResult(NamedTuple):
    F: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    best_score: torch.Tensor


def _sample_indices(key, n_hyp: int, sample_size: int, mask: torch.Tensor,
                    u: torch.Tensor | None = None) -> torch.Tensor:
    """`n_hyp` draws of `sample_size` distinct indices restricted to `mask`
    (Gumbel-top-k), as the reference draws them from `key` (a host (2,)
    uint32 key): `uniform(key, (n_hyp, n), minval=1e-6)` in float32, made on
    the mask's device. `u`: the (n_hyp, n) uniforms themselves, in place of
    `key`. Equal logits (masked-out entries) go in index order, as
    `lax.top_k` orders them."""
    n = mask.shape[-1]
    if u is None:
        u = prng.uniform_on(key, (n_hyp, n), mask.device, minval=1e-6, maxval=1.0)
    logits = torch.log(u) + torch.where(mask[None, :], 0.0, -1e30)
    return topk_stable(logits, sample_size)[1]


def ransac_fundamental(key, uv1, uv2, mask, n_iters: int = 2000,
                       thresh: float = 1.5, u=None) -> RansacResult:
    """Batched RANSAC for F; `thresh` in pixels of Sampson error."""
    idx = _sample_indices(key, n_iters, 8, mask, u)
    F_h = eight_point(uv1[idx], uv2[idx], solver="inv_iter")
    d2 = sampson_distance(F_h, uv1[None], uv2[None])
    inl = (d2 < thresh * thresh) & mask[None]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    best_inl = take(inl, best)
    best_score = take(scores, best)
    F_fit = eight_point(uv1, uv2, weights=best_inl.to(uv1.dtype))
    inl_fit = (sampson_distance(F_fit, uv1, uv2) < thresh * thresh) & mask
    use_fit = inl_fit.sum() >= best_score
    F_best = torch.where(use_fit, F_fit, take(F_h, best))
    inliers = torch.where(use_fit, inl_fit, best_inl)
    return RansacResult(F_best, inliers, inliers.sum(), best_score)


def essential_from_fundamental(F, k1, k2) -> torch.Tensor:
    K1 = cam.intrinsics_to_matrix(k1)
    K2 = cam.intrinsics_to_matrix(k2)
    return K2.transpose(-1, -2) @ F @ K1


def _w_matrix(dtype, device) -> torch.Tensor:
    """[[0, -1, 0], [1, 0, 0], [0, 0, 1]], made on the device from the
    identity's rows (no copy from the host)."""
    e = torch.eye(3, dtype=dtype, device=device)
    return torch.stack([-e[1], e[0], e[2]])


def decompose_essential(E: torch.Tensor):
    """(R1, R2, t) with det(R) = +1. The SVD's singular vectors may differ
    from LAPACK's in sign, and in the basis of E's repeated singular value;
    that only swaps R1 and R2, which the cheirality test ranks alike."""
    U, _, Vt = small_eigh.svd3(E)
    det = det3x3 if E.is_cuda else torch.linalg.det
    U = U * torch.where(det(U) < 0, -1.0, 1.0).to(E.dtype)
    Vt = Vt * torch.where(det(Vt) < 0, -1.0, 1.0).to(E.dtype)
    W = _w_matrix(E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=_EPS)
    return R1, R2, t


class TwoViewResult(NamedTuple):
    T_21: torch.Tensor
    points: torch.Tensor
    good: torch.Tensor
    n_good: torch.Tensor


def pose_from_essential(E, k1, k2, uv1, uv2, mask, min_depth: float = 1e-4,
                        max_depth: float = 1e4) -> TwoViewResult:
    """Best-cheirality (R, t) of the four candidates, with its structure."""
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    T1 = se3.identity(E.dtype, device=E.device)
    T2 = se3.from_Rt(cands_R, cands_t)
    X = triangulate.triangulate_two_view(
        k1, T1.expand(4, 3, 4), k2, T2, uv1[None], uv2[None]
    )
    z1 = X[..., 2]
    z2 = triangulate.depths(T2, X)
    ok = (z1 > min_depth) & (z1 < max_depth) & (z2 > min_depth) & (z2 < max_depth) & mask[None]
    votes = ok.sum(-1)
    best = torch.argmax(votes)
    return TwoViewResult(take(T2, best), take(X, best), take(ok, best), take(votes, best))
