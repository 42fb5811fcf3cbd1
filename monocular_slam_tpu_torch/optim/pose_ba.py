"""Motion-only bundle adjustment (counterpart of
`monocular_slam_tpu/optim/pose_ba.py`): one pose refined against fixed map
points, in rounds with chi2 gating of the edges between rounds.

Two solvers per round, as in the reference: `solver="lm"` (the default,
g2o's damped trust-region schedule; the reference's `while_loop` becomes a
fixed trip count whose steps freeze through `torch.where` once the stall
rule fires) and `solver="gn"` (min(n_iters, 3) Gauss-Newton steps with one
monotonicity guard per round), which the tracker and PnP call.

`refine_pose` takes leading batch dims, so `refine_poses_batched` (the
reference's `vmap`) is the same call on F poses at once. On CUDA tensors
`solver="gn"` is one launch of `ops/pose_gn` (`csrc/pose_gn.cu`) with the
same round logic; CPU tensors, and `solver="lm"`, run `refine_pose_plain`
op by op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.ops import pose_gn
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
    H = torch.einsum("...nai,...naj,...n->...ij", Jp, Jp, wt)
    b = -torch.einsum("...nai,...na,...n->...i", Jp, r, wt)
    return H, b, (rho * w).sum(-1), e2


def _chi2_only(T, X, k, uv, w):
    r = residuals.residual(T, X, k, uv)
    e2 = (r * r).sum(-1)
    rho, _ = robust.huber(e2, THRESH_HUBER)
    return (rho * w).sum(-1), e2


def _per_pose(c: torch.Tensor) -> torch.Tensor:
    """A (...,) condition broadcast against (..., 3, 4) poses."""
    return c[..., None, None]


def refine_pose(
    T0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    k: torch.Tensor,
    weights: torch.Tensor,
    n_iters: int = POSE_BA_ITER,
    n_rounds: int = POSE_BA_ROUNDS,
    chi2_gate: float = CHI2_GATE,
    tau: float = TAU,
    min_points: int = MIN_POINTS,
    solver: str = "lm",
) -> PoseBAResult:
    """`refine_pose_plain`'s result; `solver="gn"` on CUDA tensors from the
    `pose_gn` kernel (float32, contiguous, N <= `pose_gn.MAX_N`)."""
    if solver == "gn" and T0.is_cuda:
        return PoseBAResult(*pose_gn.refine_pose(
            T0, X, uv, k, weights, n_iters=n_iters, n_rounds=n_rounds, chi2_gate=chi2_gate,
            tau=tau, min_points=min_points, huber_delta=THRESH_HUBER))
    return refine_pose_plain(T0, X, uv, k, weights, n_iters=n_iters, n_rounds=n_rounds,
                             chi2_gate=chi2_gate, tau=tau, min_points=min_points, solver=solver)


def refine_pose_plain(
    T0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    k: torch.Tensor,
    weights: torch.Tensor,
    n_iters: int = POSE_BA_ITER,
    n_rounds: int = POSE_BA_ROUNDS,
    chi2_gate: float = CHI2_GATE,
    tau: float = TAU,
    min_points: int = MIN_POINTS,
    solver: str = "lm",
) -> PoseBAResult:
    """Motion-only BA of one pose: T0 (..., 3, 4), X (..., N, 3), uv
    (..., N, 2), k (4,), weights (..., N) >= 0 (0 masks an edge); leading
    dims are a batch of independent poses. Each round runs the solver from
    the running pose ("lm": up to n_iters damped steps, each kept only if
    the robust chi2 fell; "gn": min(n_iters, 3) Gauss-Newton steps kept
    only if the chi2 did not grow), then re-gates the edges at `chi2_gate`
    (keeping the previous weights if fewer than `min_points` pass); `tau`
    damps the GN normal equations and scales LM's first lambda. With fewer
    than `min_points` active edges the input pose is returned."""
    dtype = T0.dtype
    valid = weights > 0
    eye6 = torch.eye(6, dtype=dtype, device=T0.device)

    # each pose against its N edges
    def lin(T, w):
        return _linearize(T[..., None, :, :], X, k, uv, w)

    def chi2(T, w):
        return _chi2_only(T[..., None, :, :], X, k, uv, w)

    def gn_round(T_in, w):
        T = T_in
        for _ in range(min(n_iters, 3)):
            H, b, _, _ = lin(T, w)
            dx, _ = torch.linalg.solve_ex(H + tau * eye6, b)
            dx = torch.where(torch.isfinite(dx), dx, 0.0)
            T = se3.compose(se3.exp(dx), T)
        chi2_0, _ = chi2(T_in, w)
        chi2_n, _ = chi2(T, w)
        ok = torch.isfinite(chi2_n) & (chi2_n <= chi2_0)
        return torch.where(_per_pose(ok), T, T_in)

    def lm_round(T_in, w):
        lam = lm.init_lambda(torch.diagonal(lin(T_in, w)[0], dim1=-2, dim2=-1), tau)
        nu = torch.full_like(lam, 2.0)
        done = torch.zeros_like(lam, dtype=torch.bool)
        T = T_in
        for _ in range(n_iters):
            H, b, chi2_cur, _ = lin(T, w)
            dx, info = torch.linalg.solve_ex(H + lam[..., None, None] * eye6, b)
            # singular: NaN, as jnp.linalg.solve
            dx = torch.where((info == 0)[..., None], dx, float("nan"))
            T_new = se3.compose(se3.exp(dx), T)
            chi2_new, _ = chi2(T_new, w)
            rho = lm.gain_ratio(chi2_cur, chi2_new, dx, b, lam)
            accept = (chi2_new < chi2_cur) & torch.isfinite(chi2_new)
            lam_n, nu_n = lm.lm_step_accept(lam, nu, rho, accept)
            T = torch.where(_per_pose(accept & ~done), T_new, T)
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
        _, e2 = chi2(T, ones)
        w_new = torch.where(valid & (e2 <= chi2_gate), weights, 0.0)
        enough = (w_new > 0).sum(-1) >= min_points
        w = torch.where(enough[..., None], w_new, w)

    T_fin = torch.where(_per_pose(valid.sum(-1) >= min_points), T, T0)
    chi2_fin, e2_fin = chi2(T_fin, w)
    inl = valid & (e2_fin <= chi2_gate)
    return PoseBAResult(T_fin, inl, chi2_fin, inl.sum(-1))


def refine_poses_batched(T0, X, uv, k, weights, **kw) -> PoseBAResult:
    """Motion-only BA of F poses at once: T0 (F, 3, 4), X (F, N, 3), uv
    (F, N, 2), k (4,) shared, weights (F, N); `refine_pose`'s options."""
    return refine_pose(T0, X, uv, k, weights, **kw)
