"""Absolute Trajectory Error / Relative Pose Error — a numpy copy of
`monocular_slam_tpu/eval/ate.py` (which is numpy already; the copy keeps the
port free of the JAX package).

ATE aligns the estimate to ground truth with a Sim(3) (Umeyama/Horn — monocular
scale is unobservable) and reports RMSE of camera-center differences, the
standard TUM benchmark protocol.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity transform: dst ~ s R src + t.
    src, dst: (N, 3). Returns (s, R (3, 3), t (3,))."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """(F, 3, 4) world->camera -> (F, 3) camera centers -R^T t."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("fji,fj->fi", R, t)


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    scale: float
    errors: np.ndarray


def ate(
    poses_est: np.ndarray,
    poses_gt: np.ndarray,
    valid: np.ndarray | None = None,
    align_scale: bool = True,
) -> ATEResult:
    """ATE RMSE after Sim(3) (or SE(3) if align_scale=False) alignment.
    poses: (F, 3, 4) world->camera arrays on common frame indices."""
    if valid is not None:
        poses_est = poses_est[valid]
        poses_gt = poses_gt[valid]
    c_est = camera_centers(poses_est)
    c_gt = camera_centers(poses_gt)
    s, R, t = umeyama_sim3(c_est, c_gt)
    if not align_scale:
        s = 1.0
    c_al = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(c_al - c_gt, axis=1)
    return ATEResult(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        scale=float(s),
        errors=err,
    )



def rpe(
    poses_est: np.ndarray,
    poses_gt: np.ndarray,
    delta: int = 1,
) -> float:
    """RMSE of relative translation error over frame pairs (i, i+delta),
    after aligning global scale from ATE."""
    c_est = camera_centers(poses_est)
    c_gt = camera_centers(poses_gt)
    s, _, _ = umeyama_sim3(c_est, c_gt)
    d_est = np.linalg.norm(np.diff(c_est[::delta], axis=0), axis=1) * s
    d_gt = np.linalg.norm(np.diff(c_gt[::delta], axis=0), axis=1)
    return float(np.sqrt(((d_est - d_gt) ** 2).mean()))
