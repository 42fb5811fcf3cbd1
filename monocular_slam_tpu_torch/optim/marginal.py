"""Marginal covariance recovery from the BA normal equations (counterpart of
`monocular_slam_tpu/optim/marginal.py`, g2o's `MarginalCovarianceCholesky`).

With H = [[Hpp, W], [W^T, Hll]] and the Schur complement
S = Hpp - W Hll^-1 W^T:

    (H^-1)_pp     = S^-1                                  pose-pose marginals
    (H^-1)_ll,l   = Hll_l^-1 + Hll_l^-1 (W^T S^-1 W)_l Hll_l^-1   landmarks

as dense blocks: one Cholesky of S and two matrix products. Gauge-fixed and
unobserved vertices get zero covariance. Sized like the dense Schur path
(S needs the (F*6, P*3) cross term); a failed factorization gives NaN, as
the reference's `cho_factor` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.optim import ba as ba_mod
from monocular_slam_tpu_torch.optim.ba import _small_mm
from monocular_slam_tpu_torch.utils.linalg import inv3x3
from monocular_slam_tpu_torch.utils.scatter import segment_sum


class MarginalCovariance(NamedTuple):
    pose_cov: torch.Tensor  # (F, 6, 6) diagonal blocks of (H^-1)_pp
    point_cov: torch.Tensor  # (P, 3, 3) diagonal blocks of (H^-1)_ll
    pose_cov_full: torch.Tensor  # (F, 6, F, 6) full pose-pose marginal
    pose_ok: torch.Tensor  # (F,) free and observed
    point_ok: torch.Tensor  # (P,) observed


def marginal_covariance(prob: ba_mod.BAProblem, delta: float = ba_mod.THRESH_HUBER_FULL_BA,
                        damping: float = 1e-9) -> MarginalCovariance:
    """Marginal covariance blocks of the robustly weighted BA Hessian at the
    problem's current estimate (call it after optimizing). A monocular graph
    has a 7-dof gauge: fix at least two poses, or the scale mode makes H
    singular, as in g2o."""
    F, P = prob.poses.shape[0], prob.points.shape[0]
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    lin = ba_mod._linearize_graph(prob, prob.poses, prob.points, delta)
    dt, dev = lin["Hpp"].dtype, lin["Hpp"].device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    n_obs = prob.valid.to(torch.int32)
    pose_ok = (segment_sum(n_obs, cam, F) > 0) & ~prob.fixed
    point_ok = segment_sum(n_obs, pt, P) > 0

    # tiny damping keeps weak blocks factorizable; unobserved landmark slots
    # take an identity block
    Hll_inv = inv3x3(torch.where(point_ok[:, None, None], lin["Hll"] + damping * eye3, eye3))
    Y_e = _small_mm(lin["W_e"], Hll_inv[pt])  # (E, 6, 3)

    U, Y = ba_mod.scatter_pose_point(prob, lin["W_e"], Y_e)
    ar = torch.arange(F, device=dev)
    S = torch.zeros((F, 6, F, 6), dtype=dt, device=dev)
    S[ar, :, ar, :] = lin["Hpp"] + damping * torch.eye(6, dtype=dt, device=dev)
    S = S.reshape(F * 6, F * 6) - Y @ U.T

    # fixed and unobserved poses: identity rows, zero covariance afterwards
    free6 = pose_ok.repeat_interleave(6)
    mask2d = free6[:, None] & free6[None, :]
    S = torch.where(mask2d, S, 0.0) + torch.diag(torch.where(free6, 0.0, 1.0).to(dt))
    L, info = torch.linalg.cholesky_ex(S)
    S_inv = torch.cholesky_solve(torch.eye(F * 6, dtype=dt, device=dev), L)
    S_inv = torch.where(info == 0, S_inv, float("nan"))
    S_inv = torch.where(mask2d, S_inv, 0.0)

    pose_cov_full = S_inv.reshape(F, 6, F, 6)
    pose_cov = pose_cov_full[ar, :, ar, :]
    # (U^T S^-1 U) is needed only in its (P, 3, 3) diagonal blocks
    G = torch.einsum("ipa,ipb->pab", U.reshape(F * 6, P, 3), (S_inv @ U).reshape(F * 6, P, 3))
    point_cov = Hll_inv + _small_mm(_small_mm(Hll_inv, G), Hll_inv)
    return MarginalCovariance(
        pose_cov=torch.where(pose_ok[:, None, None], pose_cov, 0.0),
        point_cov=torch.where(point_ok[:, None, None], point_cov, 0.0),
        pose_cov_full=pose_cov_full, pose_ok=pose_ok, point_ok=point_ok,
    )
