"""Sim(3) pose-graph optimization, dense LM (counterpart of `PoseGraph`,
`edge_residual`, `_edge_weights`, `_linearize`, `optimize` and
`sequential_graph` of `monocular_slam_tpu/optim/pose_graph.py`).

Vertices are (F, 3, 5) Sim3 world->camera; an edge's residual is
e_ij = log(S_meas_ij o S_j o S_i^-1) (g2o's EdgeSim3 convention). The 7x7
Jacobians per endpoint come from `torch.func.jacfwd` through the exact
Sim3 exp/log, vmapped over the edges, as the reference takes them from
`jax.jacfwd`. The Hessian is dense (7F)^2 with a Cholesky per LM step; a
failed factorization yields NaN, which the step rejects, as the
reference's `cho_factor` does. The matrix-free `optimize_cg` is not on the
ported path (the session's keyframe bucket keeps F <= 128).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import sim3
from monocular_slam_tpu_torch.optim import lm, robust
from monocular_slam_tpu_torch.utils import autodiff


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
    H = torch.zeros((F, F, 7, 7), dtype=verts.dtype, device=verts.device)
    H.index_put_((ii, ii), Hii, accumulate=True)
    H.index_put_((jj, jj), Hjj, accumulate=True)
    H.index_put_((ii, jj), Hij, accumulate=True)
    H.index_put_((jj, ii), Hij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((F, 7), dtype=verts.dtype, device=verts.device)
    b.index_add_(0, ii, bi)
    b.index_add_(0, jj, bj)
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
                    torch.tensor(2.0, dtype=dt, device=dev), chi2_0,
                    torch.tensor(0, dtype=torch.int32, device=dev),
                    torch.tensor(False, device=dev))
    verts = g.vertices
    n_run = torch.tensor(0, dtype=torch.int32, device=dev)
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
    fixed = torch.zeros(F, dtype=torch.bool, device=dev)
    fixed[0] = True
    return PoseGraph(poses_sim3, i_idx, j_idx, meas, w, v, fixed, rob)
