"""Motion-only bundle adjustment (counterpart of
`monocular_slam_tpu/optim/pose_ba.py`): one pose refined against fixed map
points, in rounds with chi2 gating of the edges between rounds.

Two solvers per round, as in the reference: `solver="lm"` (the default,
g2o's damped trust-region schedule; the reference's `while_loop` becomes a
fixed trip count whose steps freeze through `torch.where` once the stall
rule fires) and `solver="gn"` (min(n_iters, 3) Gauss-Newton steps with one
monotonicity guard per round), which the tracker and PnP call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.optim import lm, residuals, robust

THRESH_HUBER = 5.991**0.5
CHI2_GATE = 5.991
POSE_BA_ITER = 10
POSE_BA_ROUNDS = 4
MIN_POINTS = 3
TAU = 1e-5  # constant damping of the GN normal equations


class PoseBAResult(NamedTuple):
    T: torch.Tensor
    inliers: torch.Tensor
    chi2: torch.Tensor
    n_inliers: torch.Tensor


def _linearize(T, X, k, uv, w):
    r, Jp, _ = residuals.linearize(T, X, k, uv)
    e2 = (r * r).sum(-1)
    rho, w_rob = robust.huber(e2, THRESH_HUBER)
    wt = w * w_rob
    H = torch.einsum("nai,naj,n->ij", Jp, Jp, wt)
    b = -torch.einsum("nai,na,n->i", Jp, r, wt)
    return H, b, (rho * w).sum(), e2


def _chi2_only(T, X, k, uv, w):
    r = residuals.residual(T, X, k, uv)
    e2 = (r * r).sum(-1)
    rho, _ = robust.huber(e2, THRESH_HUBER)
    return (rho * w).sum(), e2


def refine_pose(
    T0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    k: torch.Tensor,
    weights: torch.Tensor,
    n_iters: int = POSE_BA_ITER,
    n_rounds: int = POSE_BA_ROUNDS,
    solver: str = "lm",
) -> PoseBAResult:
    """Motion-only BA of one pose: T0 (3, 4), X (N, 3), uv (N, 2), k (4,),
    weights (N,) >= 0 (0 masks an edge). Each round runs the solver from
    the running pose ("lm": up to n_iters damped steps, each kept only if
    the robust chi2 fell; "gn": min(n_iters, 3) Gauss-Newton steps kept
    only if the chi2 did not grow), then re-gates the edges at CHI2_GATE;
    with fewer than MIN_POINTS active edges the input pose is returned."""
    dtype = T0.dtype
    valid = weights > 0
    eye6 = torch.eye(6, dtype=dtype, device=T0.device)

    def gn_round(T_in, w):
        T = T_in
        for _ in range(min(n_iters, 3)):
            H, b, _, _ = _linearize(T, X, k, uv, w)
            dx, _ = torch.linalg.solve_ex(H + TAU * eye6, b)
            dx = torch.where(torch.isfinite(dx), dx, 0.0)
            T = se3.compose(se3.exp(dx), T)
        chi2_0, _ = _chi2_only(T_in, X, k, uv, w)
        chi2_n, _ = _chi2_only(T, X, k, uv, w)
        ok = torch.isfinite(chi2_n) & (chi2_n <= chi2_0)
        return torch.where(ok, T, T_in)

    def lm_round(T_in, w):
        lam = lm.init_lambda(torch.diagonal(_linearize(T_in, X, k, uv, w)[0]), TAU)
        nu = torch.tensor(2.0, dtype=dtype, device=T0.device)
        done = torch.tensor(False, device=T0.device)
        T = T_in
        for _ in range(n_iters):
            H, b, chi2_cur, _ = _linearize(T, X, k, uv, w)
            dx, info = torch.linalg.solve_ex(H + lam * eye6, b)
            dx = torch.where(info == 0, dx, float("nan"))  # singular: NaN, as jnp.linalg.solve
            T_new = se3.compose(se3.exp(dx), T)
            chi2_new, _ = _chi2_only(T_new, X, k, uv, w)
            rho = lm.gain_ratio(chi2_cur, chi2_new, dx, b, lam)
            accept = (chi2_new < chi2_cur) & torch.isfinite(chi2_new)
            lam_n, nu_n = lm.lm_step_accept(lam, nu, rho, accept)
            T = torch.where(accept & ~done, T_new, T)
            lam, nu = torch.where(done, lam, lam_n), torch.where(done, nu, nu_n)
            # g2o's extra stop rule: the improvement stalled
            done = done | (accept & (chi2_cur - chi2_new < 1e-9 * chi2_cur))
        return T

    if solver not in ("lm", "gn"):
        raise ValueError(f"refine_pose: solver must be 'lm' or 'gn', got {solver!r}")
    step_round = gn_round if solver == "gn" else lm_round
    ones = torch.ones_like(weights)
    T, w = T0, weights
    for _ in range(n_rounds):
        T = step_round(T, w)
        _, e2 = _chi2_only(T, X, k, uv, ones)
        w_new = torch.where(valid & (e2 <= CHI2_GATE), weights, 0.0)
        enough = (w_new > 0).sum() >= MIN_POINTS
        w = torch.where(enough, w_new, w)

    T_fin = torch.where(valid.sum() >= MIN_POINTS, T, T0)
    chi2_fin, e2_fin = _chi2_only(T_fin, X, k, uv, w)
    inl = valid & (e2_fin <= CHI2_GATE)
    return PoseBAResult(T_fin, inl, chi2_fin, inl.sum())
