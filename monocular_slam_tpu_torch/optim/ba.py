"""Full bundle adjustment: the damped LM loop and the edge-list engine with
a dense Schur complement (counterpart of `BAProblem`, `_edge_weights`,
`_linearize_graph`, `_chi2_graph`, `_schur_solve`, `bundle_adjust` and
`global_bundle_adjust` of `monocular_slam_tpu/optim/ba.py`).

The reference's `lax.scan` over iterations with a `lax.cond` freeze becomes
a Python loop whose every decision is a `torch.where`: once the stall rule
fires, later iterations still compute a step but keep nothing of it. So an
LM solve adds no host sync. The linearization and Schur solve are plugged
in: the edge-list engine here by default, the observation grid of
`optim/window_ba.py` for local BA.

The edge-list engine scatters the per-edge pose-landmark blocks into a
dense (F*6, P*3) cross term and forms the reduced camera system with one
matmul (184 MB per cross-term array at F = 128, P = 20000); past F*P = 4e6
the loop closer plugs in the matrix-free PCG solve of `optim/cg_ba.py`.
`bundle_adjust_gn` and `bundle_adjust_dogleg` are g2o's other two
algorithms on the same engine, selectable through `bundle_adjust_with`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.optim import lm, residuals, robust
from monocular_slam_tpu_torch.utils.linalg import inv3x3
from monocular_slam_tpu_torch.utils.scatter import segment_sum, segments

THRESH_HUBER_FULL_BA = 5.99**0.5
FULL_BA_ITER = 15


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    chi2_initial: torch.Tensor
    chi2_history: torch.Tensor  # (n_iters,)
    lambda_history: torch.Tensor  # (n_iters,)
    accepted: torch.Tensor  # (n_iters,) bool
    n_iters_run: torch.Tensor


class BAProblem(NamedTuple):
    """Fixed-capacity BA graph: E edge slots with a `valid` mask."""

    poses: torch.Tensor  # (F, 3, 4) world->camera
    points: torch.Tensor  # (P, 3)
    k: torch.Tensor  # (F, 4)
    cam_idx: torch.Tensor  # (E,)
    pt_idx: torch.Tensor  # (E,)
    uv: torch.Tensor  # (E, 2)
    info: torch.Tensor  # (E,) information weight (1/scale)
    valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor  # (F,) bool gauge-fixed poses


def _edge_weights(prob: BAProblem, r: torch.Tensor, delta: float):
    """Robust IRLS weight per edge (info * huber') and the robust chi2."""
    e2 = (r * r).sum(-1) * prob.info
    rho, w_rob = robust.huber(e2, delta)
    w = torch.where(prob.valid, prob.info * w_rob, 0.0)
    return w, torch.where(prob.valid, rho, 0.0).sum()


def _small_mm(A, B):
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _small_mv(A, x):
    return (A * x[..., None, :]).sum(-1)


def _linearize_graph(prob: BAProblem, poses, points, delta: float):
    """Every edge linearized in one batch, reduced to block normal
    equations by segment sums over cameras and points. The two segment
    plans (`cam_seg`, `pt_seg`) ride along for the solves' sums; they drop
    the invalid edges, whose weight, and so every block, is 0."""
    F, P = poses.shape[0], points.shape[0]
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    cam_seg, pt_seg = segments(cam, F, prob.valid), segments(pt, P, prob.valid)
    r, Jp, Jl = residuals.linearize(poses[cam], points[pt], prob.k[cam], prob.uv)
    w, chi2 = _edge_weights(prob, r, delta)

    def outer2(A, B):  # (E, 2, m), (E, 2, n) -> (E, m, n) weighted by w
        Aw = A * w[:, None, None]
        return (Aw[..., :, None] * B[..., None, :]).sum(-3)

    rw = (r * w[:, None])[..., None]
    return dict(
        chi2=chi2,
        Hpp=segment_sum(outer2(Jp, Jp), cam_seg),
        Hll=segment_sum(outer2(Jl, Jl), pt_seg),
        bp=segment_sum(-(Jp * rw).sum(-2), cam_seg),
        bl=segment_sum(-(Jl * rw).sum(-2), pt_seg),
        W_e=outer2(Jp, Jl),
        cam_seg=cam_seg,
        pt_seg=pt_seg,
    )


def scatter_pose_point(prob: BAProblem, *blocks):
    """Each (E, 6, 3) array of edge blocks (zero on invalid edges) summed
    into a dense (F*6, P*3) cross term, by deterministic segment sums over
    the (camera, point) pairs (one plan for all). Returns a list."""
    F, P = prob.poses.shape[0], prob.points.shape[0]
    pair = segments(prob.cam_idx.long() * P + prob.pt_idx.long(), F * P, prob.valid)
    return [segment_sum(b, pair).reshape(F, P, 6, 3).permute(0, 2, 1, 3).reshape(F * 6, P * 3)
            for b in blocks]


def keep_where(accept, new: dict, old: dict) -> dict:
    """The linearization `new` where `accept`, else `old`; the segment plans
    are the same in both."""
    return {n: torch.where(accept, v, old[n]) if torch.is_tensor(v) else v
            for n, v in new.items()}


def _chi2_graph(prob: BAProblem, poses, points, delta: float):
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    r = residuals.residual(poses[cam], points[pt], prob.k[cam], prob.uv)
    return _edge_weights(prob, r, delta)[1]


def _schur_solve(prob: BAProblem, lin, lam, reduce=lm.no_reduce):
    """Damped Schur-reduced solve with a dense (F*6, F*6) Cholesky; a failed
    factorization yields NaN, as the reference's `cho_factor` does.
    Returns (dxp (F, 6), dxl (P, 3), b_red). With `reduce`, `prob` holds one
    rank's landmarks and their edges, `lin`'s pose blocks are already summed
    over the ranks, and the cross term and the reduced gradient are summed
    over them too (`parallel/sharded_ba.py`)."""
    F, P = lin["Hpp"].shape[0], lin["Hll"].shape[0]
    dt, dev = lin["Hpp"].dtype, lin["Hpp"].device
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    cam_seg, pt_seg = lin["cam_seg"], lin["pt_seg"]
    Hpp_d = lin["Hpp"] + lam * torch.eye(6, dtype=dt, device=dev)
    Hll_inv = inv3x3(lin["Hll"] + lam * torch.eye(3, dtype=dt, device=dev))
    Y_e = _small_mm(lin["W_e"], Hll_inv[pt])  # (E, 6, 3)

    U, Y = scatter_pose_point(prob, lin["W_e"], Y_e)
    b_red = lin["bp"] - reduce(segment_sum(_small_mv(Y_e, lin["bl"][pt]), cam_seg))
    ar = torch.arange(F, device=dev)
    S = torch.zeros((F, 6, F, 6), dtype=dt, device=dev)
    S[ar, :, ar, :] = Hpp_d
    S = S.reshape(F * 6, F * 6) - reduce(Y @ U.T)
    del U, Y

    free = ~prob.fixed
    free6 = free.repeat_interleave(6)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, 0.0, 1.0).to(dt))
    b_red = torch.where(free[:, None], b_red, 0.0).reshape(F * 6)
    L, info = torch.linalg.cholesky_ex(S)
    dxp = torch.cholesky_solve(b_red[:, None], L)[:, 0]
    dxp = torch.where(info == 0, dxp, float("nan")).reshape(F, 6)

    wt_dxp_e = (lin["W_e"] * dxp[cam][..., None]).sum(-2)  # (E, 3)
    dxl = _small_mv(Hll_inv, lin["bl"] - segment_sum(wt_dxp_e, pt_seg))
    return dxp, dxl, b_red.reshape(F, 6)


def bundle_adjust(prob, n_iters: int = FULL_BA_ITER, delta: float = THRESH_HUBER_FULL_BA,
                  tau: float = 1e-5, solve_fn=None, linearize_fn=None) -> BAResult:
    """LM over `prob` with one linearization per iteration, carried across
    iterations and replaced only when a step is accepted.
    linearize_fn(prob, poses, points, delta) -> dict(chi2, Hpp, Hll, bp, bl,
    W_e); solve_fn(prob, lin, lam) -> (dxp (F, 6), dxl (P, 3), b_red).
    Both default to the edge-list engine above."""
    if solve_fn is None:
        solve_fn = _schur_solve
    if linearize_fn is None:
        linearize_fn = _linearize_graph
    dtype = prob.poses.dtype
    dev = prob.poses.device
    lin = linearize_fn(prob, prob.poses, prob.points, delta)
    diag0 = torch.cat([
        torch.diagonal(lin["Hpp"], dim1=-2, dim2=-1).reshape(-1),
        torch.diagonal(lin["Hll"], dim1=-2, dim2=-1).reshape(-1),
    ])
    chi2_init = lin["chi2"]
    st = lm.LMState(
        lm.init_lambda(diag0, tau), torch.tensor(2.0, dtype=dtype, device=dev),
        lin["chi2"], torch.tensor(0, dtype=torch.int32, device=dev),
        torch.tensor(False, device=dev),
    )
    poses, points = prob.poses, prob.points
    chi2_h, lam_h, acc_h = [], [], []
    for _ in range(n_iters):
        dxp, dxl, _ = solve_fn(prob, lin, st.lam)
        poses_new = se3.compose(se3.exp(dxp), poses)
        points_new = points + dxl
        lin_new = linearize_fn(prob, poses_new, points_new, delta)
        chi2_new = lin_new["chi2"]
        dx_all = torch.cat([dxp.reshape(-1), dxl.reshape(-1)])
        b_all = torch.cat([lin["bp"].reshape(-1), lin["bl"].reshape(-1)])
        rho = lm.gain_ratio(lin["chi2"], chi2_new, dx_all, b_all, st.lam)
        accept = (chi2_new < lin["chi2"]) & torch.isfinite(chi2_new) & ~st.done
        lam_new, nu_new = lm.lm_step_accept(st.lam, st.nu, rho, accept)
        stall = accept & (lin["chi2"] - chi2_new < 1e-6 * lin["chi2"])
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lin = keep_where(accept, lin_new, lin)
        st = lm.LMState(
            torch.where(st.done, st.lam, lam_new),
            torch.where(st.done, st.nu, nu_new),
            lin["chi2"], st.it + 1, st.done | stall,
        )
        chi2_h.append(st.chi2)
        lam_h.append(st.lam)
        acc_h.append(accept)
    return BAResult(poses, points, chi2_init, torch.stack(chi2_h),
                    torch.stack(lam_h), torch.stack(acc_h), st.it)


def global_bundle_adjust(prob: BAProblem, n_iters: int = FULL_BA_ITER) -> BAResult:
    """All-frames, all-points BA on the edge-list engine."""
    return bundle_adjust(prob, n_iters=n_iters)


def _hessian_vecprod(prob: BAProblem, lin, xp, xl):
    """(H x) from the block linearization without forming H:
    (Hx)_p = Hpp x_p + sum_e W_e x_l(e); (Hx)_l = Hll x_l + sum_e W_e^T x_p(e)."""
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    cam_seg, pt_seg = lin["cam_seg"], lin["pt_seg"]
    hp = _small_mv(lin["Hpp"], xp) + segment_sum(_small_mv(lin["W_e"], xl[pt]), cam_seg)
    hl = _small_mv(lin["Hll"], xl) + segment_sum((lin["W_e"] * xp[cam][..., None]).sum(-2), pt_seg)
    return hp, hl


def _start(prob, solve_fn, linearize_fn, delta):
    """Default engines, the first linearization and the vanishing damping
    floor (1e-12 x max diagonal) of the undamped algorithms."""
    solve_fn = _schur_solve if solve_fn is None else solve_fn
    linearize_fn = _linearize_graph if linearize_fn is None else linearize_fn
    lin = linearize_fn(prob, prob.poses, prob.points, delta)
    diag0 = torch.cat([torch.diagonal(lin["Hpp"], dim1=-2, dim2=-1).reshape(-1),
                       torch.diagonal(lin["Hll"], dim1=-2, dim2=-1).reshape(-1)])
    return solve_fn, linearize_fn, lin, 1e-12 * torch.clamp(diag0.max(), min=1.0)


def bundle_adjust_gn(prob: BAProblem, n_iters: int = FULL_BA_ITER,
                     delta: float = THRESH_HUBER_FULL_BA, solve_fn=None,
                     linearize_fn=None) -> BAResult:
    """Gauss-Newton (g2o's `OptimizationAlgorithmGaussNewton`): the undamped
    step applied unconditionally; a non-finite candidate or a relative chi2
    change below 1e-9 freezes the run. The damping floor keeps padding
    landmark blocks factorizable (their rhs is 0, so their update is 0)."""
    dt, dev = prob.poses.dtype, prob.poses.device
    solve_fn, linearize_fn, lin, lam_floor = _start(prob, solve_fn, linearize_fn, delta)
    chi2_init = lin["chi2"]
    st = lm.LMState(torch.tensor(0.0, dtype=dt, device=dev), torch.tensor(2.0, dtype=dt, device=dev),
                    lin["chi2"], torch.tensor(0, dtype=torch.int32, device=dev),
                    torch.tensor(False, device=dev))
    poses, points = prob.poses, prob.points
    chi2_h, lam_h, acc_h = [], [], []
    for _ in range(n_iters):
        dxp, dxl, _ = solve_fn(prob, lin, lam_floor)
        poses_new = se3.compose(se3.exp(dxp), poses)
        points_new = points + dxl
        lin_new = linearize_fn(prob, poses_new, points_new, delta)
        ok = torch.isfinite(lin_new["chi2"])
        chi2_out = torch.where(ok, lin_new["chi2"], lin["chi2"])
        stall = ~ok | ((lin["chi2"] - chi2_out).abs() < 1e-9 * (lin["chi2"] + 1e-30))
        accept = ok & ~st.done
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lin = keep_where(accept, lin_new, lin)
        st = st._replace(chi2=lin["chi2"], it=st.it + 1, done=st.done | stall)
        chi2_h.append(st.chi2)
        lam_h.append(st.lam)
        acc_h.append(accept)
    return BAResult(poses, points, chi2_init, torch.stack(chi2_h),
                    torch.stack(lam_h), torch.stack(acc_h), st.it)


def bundle_adjust_dogleg(prob: BAProblem, n_iters: int = FULL_BA_ITER,
                         delta: float = THRESH_HUBER_FULL_BA, radius0: float = 1.0,
                         solve_fn=None, linearize_fn=None) -> BAResult:
    """Powell's dogleg (g2o's `OptimizationAlgorithmDogleg`): the Cauchy
    point and the Gauss-Newton step blended inside a trust region of radius
    Delta, which grows to max(Delta, 3|h|) when the gain ratio exceeds 0.75
    and halves below 0.25. `lambda_history` records Delta."""
    dt, dev = prob.poses.dtype, prob.poses.device
    solve_fn, linearize_fn, lin, lam_floor = _start(prob, solve_fn, linearize_fn, delta)
    chi2_init = lin["chi2"]
    st = lm.LMState(torch.tensor(radius0, dtype=dt, device=dev), torch.tensor(2.0, dtype=dt, device=dev),
                    lin["chi2"], torch.tensor(0, dtype=torch.int32, device=dev),
                    torch.tensor(False, device=dev))
    poses, points = prob.poses, prob.points

    def dot(ap, al, bp, bl):
        return (ap * bp).sum() + (al * bl).sum()

    chi2_h, rad_h, acc_h = [], [], []
    for _ in range(n_iters):
        radius = st.lam
        gp, gl, _ = solve_fn(prob, lin, lam_floor)  # Gauss-Newton step
        bp, bl = lin["bp"], lin["bl"]
        # Cauchy point: alpha = |b|^2 / (b^T H b), h_sd = alpha b
        alpha = dot(bp, bl, bp, bl) / (dot(bp, bl, *_hessian_vecprod(prob, lin, bp, bl)) + 1e-30)
        sp, sl = alpha * bp, alpha * bl
        n_gn = torch.sqrt(dot(gp, gl, gp, gl))
        n_sd = torch.sqrt(dot(sp, sl, sp, sl))
        # blend: h = h_sd + beta (h_gn - h_sd) with |h| = Delta
        ap, al = gp - sp, gl - sl
        a2 = dot(ap, al, ap, al) + 1e-30
        c = dot(sp, sl, ap, al)
        gap = radius**2 - n_sd**2
        disc = torch.sqrt(torch.clamp(c * c + a2 * gap, min=0.0))
        beta = torch.where(c <= 0, (-c + disc) / a2, gap / (c + disc))
        use_gn = n_gn <= radius
        use_sd = ~use_gn & (n_sd >= radius)
        scale_sd = radius / torch.clamp(n_sd, min=1e-30)
        dxp = torch.where(use_gn, gp, torch.where(use_sd, scale_sd * sp, sp + beta * ap))
        dxl = torch.where(use_gn, gl, torch.where(use_sd, scale_sd * sl, sl + beta * al))

        poses_new = se3.compose(se3.exp(dxp), poses)
        points_new = points + dxl
        lin_new = linearize_fn(prob, poses_new, points_new, delta)
        chi2_new = lin_new["chi2"]
        # gain ratio against the quadratic model
        pred = dot(dxp, dxl, bp, bl) - 0.5 * dot(dxp, dxl, *_hessian_vecprod(prob, lin, dxp, dxl))
        rho = (lin["chi2"] - chi2_new) / (pred + 1e-30)
        step_ok = (chi2_new < lin["chi2"]) & torch.isfinite(chi2_new)
        h_norm = torch.sqrt(dot(dxp, dxl, dxp, dxl))
        radius_new = torch.where(rho > 0.75, torch.maximum(radius, 3.0 * h_norm), radius)
        radius_new = torch.where(rho < 0.25, radius_new * 0.5, radius_new)
        stall = (step_ok & (lin["chi2"] - chi2_new < 1e-9 * lin["chi2"])) | (radius_new < 1e-12)
        accept = step_ok & ~st.done
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lin = keep_where(accept, lin_new, lin)
        st = st._replace(lam=torch.where(st.done, radius, radius_new), chi2=lin["chi2"],
                         it=st.it + 1, done=st.done | stall)
        chi2_h.append(st.chi2)
        rad_h.append(st.lam)
        acc_h.append(accept)
    return BAResult(poses, points, chi2_init, torch.stack(chi2_h),
                    torch.stack(rad_h), torch.stack(acc_h), st.it)


ALGORITHMS = {
    "lm": bundle_adjust,
    "gn": bundle_adjust_gn,
    "dogleg": bundle_adjust_dogleg,
}


def bundle_adjust_with(algorithm: str, prob: BAProblem, **kw) -> BAResult:
    """BA by name, "lm", "gn" or "dogleg" (the role of g2o's
    `OptimizationAlgorithmFactory`)."""
    return ALGORITHMS[algorithm](prob, **kw)
