"""Sim(3) pose-graph optimization, dense LM (counterpart of `PoseGraph`,
`edge_residual`, `_edge_weights`, `_linearize`, `optimize` and
`sequential_graph` of `monocular_slam_tpu/optim/pose_graph.py`).

Vertices are (F, 3, 5) Sim3 world->camera; an edge's residual is
e_ij = log(S_meas_ij o S_j o S_i^-1) (g2o's EdgeSim3 convention). The 7x7
Jacobians per endpoint come from `torch.func.jacfwd` through the exact
Sim3 exp/log, vmapped over the edges, as the reference takes them from
`jax.jacfwd`. `optimize` forms the dense (7F)^2 Hessian with a Cholesky per
LM step; a failed factorization yields NaN, which the step rejects, as the
reference's `cho_factor` does. `optimize_cg` keeps the same LM schedule on
per-edge blocks and solves each step with block-Jacobi PCG
(`optim/cg_ba.pcg`), never forming the Hessian: the loop closer's route
for keyframe graphs past 512 vertices. Its LM iteration is a function of
its own (`optimize_cg_step`), which the loop closer's captured program
replays once per iteration. Every sum over edges is a
deterministic segment sum (`utils/scatter.py`), so a solve repeats bit for
bit on the card; the matrix-free path plans its sums once per
linearization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import sim3
from monocular_slam_tpu_torch.optim import cg_ba, lm, robust
from monocular_slam_tpu_torch.utils import autodiff
from monocular_slam_tpu_torch.utils.scatter import segment_sum, segments


class PoseGraph(NamedTuple):
    vertices: torch.Tensor  # (F, 3, 5) Sim3 world->camera
    i_idx: torch.Tensor  # (E,) edge endpoints
    j_idx: torch.Tensor  # (E,)
    meas: torch.Tensor  # (E, 3, 5) S_ij = S_i o S_j^-1
    weight: torch.Tensor  # (E,)
    valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor  # (F,) bool
    robust: torch.Tensor | None = None  # (E,) bool; None = every edge robust


class PoseGraphResult(NamedTuple):
    vertices: torch.Tensor
    chi2_initial: torch.Tensor
    chi2_history: torch.Tensor
    n_iters_run: torch.Tensor


def edge_residual(S_i, S_j, S_meas):
    """e = log(S_meas o S_j o S_i^-1), (..., 7)."""
    return sim3.log(sim3.compose(S_meas, sim3.compose(S_j, sim3.inverse(S_i))))


def _residual_wrt_updates(xi_i, xi_j, S_i, S_j, S_meas):
    return edge_residual(sim3.compose(sim3.exp(xi_i), S_i),
                         sim3.compose(sim3.exp(xi_j), S_j), S_meas)


def edge_jacobians(S_i, S_j, S_meas):
    """(Ji, Jj) (E, 7, 7): d e / d xi at xi = 0 for left updates of S_i, S_j."""
    z7 = torch.zeros(7, dtype=S_i.dtype, device=S_i.device)
    return autodiff.jacfwd(_residual_wrt_updates, z7, z7, S_i, S_j, S_meas, argnums=(0, 1),
                           vmap_dims=(None, None, 0, 0, 0))


def _edge_weights(g: PoseGraph, r, huber_delta):
    """Per-edge effective weight and robust chi2 (Huber IRLS on the edges
    marked robust)."""
    w = torch.where(g.valid, g.weight, 0.0)
    e2 = (r * r).sum(-1) * w
    if huber_delta is None:
        return w, e2.sum()
    rho, w_rob = robust.huber(e2, huber_delta)
    if g.robust is not None:
        w_rob = torch.where(g.robust, w_rob, 1.0)
        rho = torch.where(g.robust, rho, e2)
    return w * w_rob, torch.where(g.valid, rho, 0.0).sum()


def _linearize(g: PoseGraph, verts, huber_delta=None):
    """Dense H (F, 7, F, 7), gradient b (F, 7) and chi2 at `verts`."""
    F = verts.shape[0]
    S_i, S_j = verts[g.i_idx.long()], verts[g.j_idx.long()]
    r = edge_residual(S_i, S_j, g.meas)
    Ji, Jj = edge_jacobians(S_i, S_j, g.meas)
    w, chi2 = _edge_weights(g, r, huber_delta)
    Hii = torch.einsum("eai,eaj,e->eij", Ji, Ji, w)
    Hjj = torch.einsum("eai,eaj,e->eij", Jj, Jj, w)
    Hij = torch.einsum("eai,eaj,e->eij", Ji, Jj, w)
    bi = -torch.einsum("eai,ea,e->ei", Ji, r, w)
    bj = -torch.einsum("eai,ea,e->ei", Jj, r, w)
    ii, jj = g.i_idx.long(), g.j_idx.long()
    pairs = torch.cat([ii * F + ii, jj * F + jj, ii * F + jj, jj * F + ii])
    H = segment_sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]),
                    segments(pairs, F * F, g.valid.repeat(4)))
    b = segment_sum(torch.cat([bi, bj]), segments(torch.cat([ii, jj]), F, g.valid.repeat(2)))
    H = H.reshape(F, F, 7, 7)
    return H.permute(0, 2, 1, 3), b, chi2


def _chi2(g: PoseGraph, verts, huber_delta=None):
    r = edge_residual(verts[g.i_idx.long()], verts[g.j_idx.long()], g.meas)
    return _edge_weights(g, r, huber_delta)[1]


def optimize(g: PoseGraph, n_iters: int = 20, tau: float = 1e-5,
             huber_delta=None) -> PoseGraphResult:
    """Damped LM on the Sim3 pose graph; fixed vertices pinned by identity
    rows. Every decision is a `torch.where`: once the stall rule fires the
    later iterations keep nothing, so the loop adds no host sync."""
    F = g.vertices.shape[0]
    dt = g.vertices.dtype
    dev = g.vertices.device
    free7 = (~g.fixed).repeat_interleave(7)
    mask2d = free7[:, None] & free7[None, :]
    pin = torch.diag(torch.where(free7, 0.0, 1.0).to(dt))
    eye = torch.eye(F * 7, dtype=dt, device=dev)

    H0, _, chi2_0 = _linearize(g, g.vertices, huber_delta)
    st = lm.LMState(lm.init_lambda(torch.diagonal(H0.reshape(F * 7, F * 7)), tau),
                    torch.full((), 2.0, dtype=dt, device=dev), chi2_0,
                    torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
    verts = g.vertices
    n_run = torch.zeros((), dtype=torch.int32, device=dev)
    chi2_h = []
    for _ in range(n_iters):
        n_run = n_run + (~st.done).to(torch.int32)
        H, b, chi2_cur = _linearize(g, verts, huber_delta)
        Hm = torch.where(mask2d, H.reshape(F * 7, F * 7) + st.lam * eye, 0.0) + pin
        bv = torch.where(free7, b.reshape(-1), 0.0)
        L, info = torch.linalg.cholesky_ex(Hm)
        dx = torch.cholesky_solve(bv[:, None], L)[:, 0]
        dx = torch.where(info == 0, dx, float("nan")).reshape(F, 7)
        verts_new = sim3.compose(sim3.exp(dx), verts)
        chi2_new = _chi2(g, verts_new, huber_delta)
        rho = lm.gain_ratio(chi2_cur, chi2_new, dx.reshape(-1), bv, st.lam)
        step_ok = (chi2_new < chi2_cur) & torch.isfinite(chi2_new)
        lam_n, nu_n = lm.lm_step_accept(st.lam, st.nu, rho, step_ok)
        accept = step_ok & ~st.done
        verts = torch.where(accept, verts_new, verts)
        stall = step_ok & (chi2_cur - chi2_new < 1e-9 * (chi2_cur + 1e-30))
        st = lm.LMState(
            torch.where(st.done, st.lam, lam_n), torch.where(st.done, st.nu, nu_n),
            torch.where(st.done, st.chi2, torch.where(step_ok, chi2_new, chi2_cur)),
            st.it + 1, st.done | stall,
        )
        chi2_h.append(st.chi2)
    return PoseGraphResult(verts, chi2_0, torch.stack(chi2_h), n_run)


def _linearize_blocks(g: PoseGraph, verts, huber_delta=None):
    """Per-edge linearization for the matrix-free path: residuals, Jacobians,
    weights, chi2, gradient b (F, 7), the block diagonal D (F, 7, 7) of H and
    the segment plan `seg` over the edges' endpoints (i, then j)."""
    F = verts.shape[0]
    ii, jj = g.i_idx.long(), g.j_idx.long()
    S_i, S_j = verts[ii], verts[jj]
    r = edge_residual(S_i, S_j, g.meas)
    Ji, Jj = edge_jacobians(S_i, S_j, g.meas)
    w, chi2 = _edge_weights(g, r, huber_delta)
    # the plan of every sum over the endpoints; invalid edges weigh 0
    seg = segments(torch.cat([ii, jj]), F, torch.cat([g.valid, g.valid]))
    b = segment_sum(-torch.cat([torch.einsum("eai,ea,e->ei", Ji, r, w),
                                torch.einsum("eai,ea,e->ei", Jj, r, w)]), seg)
    D = segment_sum(torch.cat([torch.einsum("eai,eaj,e->eij", Ji, Ji, w),
                               torch.einsum("eai,eaj,e->eij", Jj, Jj, w)]), seg)
    return dict(r=r, Ji=Ji, Jj=Jj, w=w, chi2=chi2, b=b, D=D, seg=seg)


def _hessian_matvec(g: PoseGraph, lin, lam, free, x, reduce=lm.no_reduce):
    """y = (H + lam I) x, gauge-masked (fixed rows act as identity), from the
    edge blocks: O(E) work and memory. `reduce` sums the edge sums over the
    ranks that share the edges (`parallel/sharded_pose_graph.py`)."""
    ii, jj = g.i_idx.long(), g.j_idx.long()
    xf = torch.where(free[:, None], x, 0.0)
    ge = lin["w"][:, None] * (torch.einsum("eai,ei->ea", lin["Ji"], xf[ii])
                              + torch.einsum("eai,ei->ea", lin["Jj"], xf[jj]))
    y = reduce(segment_sum(torch.cat([torch.einsum("eai,ea->ei", lin["Ji"], ge),
                                      torch.einsum("eai,ea->ei", lin["Jj"], ge)]), lin["seg"]))
    y = torch.where(free[:, None], y + lam * xf, 0.0)
    return y + torch.where(free[:, None], 0.0, x)


class CGCarry(NamedTuple):
    """What one LM iteration of `optimize_cg` hands the next."""

    verts: torch.Tensor
    st: lm.LMState
    n_run: torch.Tensor


def _linearize_reduced(g: PoseGraph, verts, huber_delta, reduce):
    lin = _linearize_blocks(g, verts, huber_delta)
    lin["chi2"], lin["b"], lin["D"] = reduce(lin["chi2"], lin["b"], lin["D"])
    return lin


def optimize_cg_start(g: PoseGraph, tau: float = 1e-5, huber_delta=None,
                      reduce=lm.no_reduce) -> tuple[CGCarry, torch.Tensor]:
    """`optimize_cg`'s first linearization: the carry before its first LM
    iteration, and the initial chi2."""
    dt, dev = g.vertices.dtype, g.vertices.device
    lin0 = _linearize_reduced(g, g.vertices, huber_delta, reduce)
    st = lm.LMState(lm.init_lambda(torch.diagonal(lin0["D"], dim1=-2, dim2=-1).reshape(-1), tau),
                    torch.full((), 2.0, dtype=dt, device=dev), lin0["chi2"],
                    torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
    return CGCarry(g.vertices, st, torch.zeros((), dtype=torch.int32, device=dev)), lin0["chi2"]


def optimize_cg_step(g: PoseGraph, carry: CGCarry, max_cg_iters: int = 100, rtol: float = 1e-8,
                     huber_delta=None, reduce=lm.no_reduce) -> CGCarry:
    """One LM iteration of `optimize_cg`: the loop's body, which the loop
    closer's captured program replays `n_iters` times with the carry in
    static buffers. Once the stall rule has fired it keeps nothing."""
    dt, dev = g.vertices.dtype, g.vertices.device
    free = ~g.fixed
    eye7 = torch.eye(7, dtype=dt, device=dev)
    verts, st = carry.verts, carry.st
    n_run = carry.n_run + (~st.done).to(torch.int32)
    lin = _linearize_reduced(g, verts, huber_delta, reduce)
    lam = st.lam
    D_inv, info = torch.linalg.inv_ex(torch.where(free[:, None, None], lin["D"] + lam * eye7, eye7))
    D_inv = torch.where((info == 0)[:, None, None], D_inv, float("nan"))
    b = torch.where(free[:, None], lin["b"], 0.0)
    dx, _ = cg_ba.pcg(
        lambda x: _hessian_matvec(g, lin, lam, free, x, reduce),
        lambda r: torch.where(free[:, None], (D_inv * r[:, None, :]).sum(-1), 0.0),
        b, max_cg_iters, rtol)
    verts_new = sim3.compose(sim3.exp(dx), verts)
    chi2_cur, chi2_new = lin["chi2"], reduce(_chi2(g, verts_new, huber_delta))
    rho = lm.gain_ratio(chi2_cur, chi2_new, dx.reshape(-1), b.reshape(-1), lam)
    step_ok = (chi2_new < chi2_cur) & torch.isfinite(chi2_new)
    lam_n, nu_n = lm.lm_step_accept(lam, st.nu, rho, step_ok)
    verts = torch.where(step_ok & ~st.done, verts_new, verts)
    stall = step_ok & (chi2_cur - chi2_new < 1e-9 * (chi2_cur + 1e-30))
    st = lm.LMState(
        torch.where(st.done, lam, lam_n), torch.where(st.done, st.nu, nu_n),
        torch.where(st.done, st.chi2, torch.where(step_ok, chi2_new, chi2_cur)),
        st.it + 1, st.done | stall,
    )
    return CGCarry(verts, st, n_run)


def optimize_cg(g: PoseGraph, n_iters: int = 20, tau: float = 1e-5, max_cg_iters: int = 100,
                rtol: float = 1e-8, huber_delta=None, reduce=lm.no_reduce) -> PoseGraphResult:
    """`optimize`'s LM schedule with each damped step (H + lam I) dx = b
    solved by block-Jacobi PCG, matrix-free: `optimize_cg_start`, then
    `optimize_cg_step` n_iters times. `n_iters_run` counts the LM
    iterations that ran before the stall rule froze the loop. With `reduce`,
    `g` holds one rank's edges (all vertices) and every sum over edges is
    summed over the ranks: the gradient, the diagonal blocks and chi2 once
    per linearization, one (F, 7) vector per PCG step."""
    carry, chi2_0 = optimize_cg_start(g, tau, huber_delta, reduce)
    chi2_h = []
    for _ in range(n_iters):
        carry = optimize_cg_step(g, carry, max_cg_iters, rtol, huber_delta, reduce)
        chi2_h.append(carry.st.chi2)
    return PoseGraphResult(carry.verts, chi2_0, torch.stack(chi2_h), carry.n_run)


def sequential_graph(poses_sim3, valid, extra_i=None, extra_j=None, extra_meas=None,
                     extra_weight=None, extra_valid=None, loop_weight: float = 5.0) -> PoseGraph:
    """Odometry edges between consecutive vertices (measured from the
    current estimates) plus optional loop edges; `extra_valid` masks padded
    loop edges. Loop edges are exempt from the robust kernel."""
    F = poses_sim3.shape[0]
    dev = poses_sim3.device
    i_idx = torch.arange(F - 1, dtype=torch.int32, device=dev)
    j_idx = i_idx + 1
    meas = sim3.compose(poses_sim3[:-1], sim3.inverse(poses_sim3[1:]))
    w = torch.ones(F - 1, dtype=poses_sim3.dtype, device=dev)
    v = valid[:-1] & valid[1:]
    rob = torch.ones(F - 1, dtype=torch.bool, device=dev)
    if extra_i is not None:
        extra_i = torch.as_tensor(extra_i, dtype=torch.int32, device=dev)
        n = extra_i.shape[0]
        i_idx = torch.cat([i_idx, extra_i])
        j_idx = torch.cat([j_idx, torch.as_tensor(extra_j, dtype=torch.int32, device=dev)])
        meas = torch.cat([meas, extra_meas.to(meas.dtype)])
        ew = (torch.as_tensor(extra_weight, dtype=w.dtype, device=dev) if extra_weight is not None
              else torch.full((n,), loop_weight, dtype=w.dtype, device=dev))
        w = torch.cat([w, ew])
        ev = (torch.as_tensor(extra_valid, dtype=torch.bool, device=dev) if extra_valid is not None
              else torch.ones(n, dtype=torch.bool, device=dev))
        v = torch.cat([v, ev])
        rob = torch.cat([rob, torch.zeros(n, dtype=torch.bool, device=dev)])
    fixed = torch.arange(F, device=dev) == 0
    return PoseGraph(poses_sim3, i_idx, j_idx, meas, w, v, fixed, rob)
