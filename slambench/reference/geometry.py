"""Plain float64 NumPy geometry for judging a run: Sim(3) alignment of a
trajectory to the course's ground truth, the relative pose error between
consecutive frames, and the reprojection of map points into the frames
that observe them."""

from __future__ import annotations

import numpy as np


def centres(poses: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of (n, 3, 4) world->camera poses."""
    poses = np.asarray(poses, np.float64)
    return -np.einsum("nji,nj->ni", poses[:, :, :3], poses[:, :, 3])


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) minimising |s R src + t - dst|^2 over (n, 3) point sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    cov = b.T @ a / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    var = (a ** 2).sum() / len(src)
    s = float(np.trace(np.diag(S) @ D) / var) if var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def rpe_mm(poses: np.ndarray, gt: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """Translation error (mm) of each consecutive pair of frames that are
    both `ok`: the estimated step, under the Sim(3) that aligns the `ok`
    centres to the ground truth's, against the true step."""
    c, g = centres(poses), centres(gt)
    if ok.sum() < 3:
        return np.full(1, np.inf)
    s, R, _ = umeyama(c[ok], g[ok])
    pair = ok[1:] & ok[:-1]
    est = s * (np.diff(c, axis=0) @ R.T)
    err = np.linalg.norm(est - np.diff(g, axis=0), axis=1)[pair]
    return err * 1e3 if len(err) else np.full(1, np.inf)


def rpe_rot_mrad(poses: np.ndarray, gt: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """Rotation error (mrad) of each consecutive pair of `ok` frames: the
    estimated relative rotation R_{i+1} R_i^T against the true one, as
    |difference|_F / sqrt(2) (the angle, for small rotations; defined for
    matrices that rounding left slightly off orthonormal). Free of the
    trajectory's scale and of the alignment."""
    R = np.asarray(poses, np.float64)[:, :, :3]
    G = np.asarray(gt, np.float64)[:, :, :3]
    pair = ok[1:] & ok[:-1]
    rel = R[1:] @ np.swapaxes(R[:-1], 1, 2)
    rel_gt = G[1:] @ np.swapaxes(G[:-1], 1, 2)
    err = np.linalg.norm(rel - rel_gt, axis=(1, 2))[pair] / np.sqrt(2.0) * 1e3
    return err if len(err) else np.full(1, np.inf)


def ate_cm(poses: np.ndarray, gt: np.ndarray, ok: np.ndarray) -> float:
    """RMS distance (cm) of the `ok` centres from the ground truth's after
    Sim(3) alignment."""
    c, g = centres(poses)[ok], centres(gt)[ok]
    if len(c) < 3:
        return float("inf")
    s, R, t = umeyama(c, g)
    return float(np.sqrt(((s * c @ R.T + t - g) ** 2).sum(1).mean()) * 100.0)


def reprojection_px(poses, k, uv, scale, point_ids, points) -> np.ndarray:
    """Reprojection error of each observation in pyramid-level pixels:
    |project(k, pose (R X + t)) - uv| / scale. poses (n, 3, 4) and k (n, 4)
    of the observing frames, uv (n, 2), scale (n,), point_ids (n,) into
    points (P, 3). Points behind the camera read inf."""
    poses = np.asarray(poses, np.float64)
    X = np.asarray(points, np.float64)[point_ids]
    Xc = np.einsum("nij,nj->ni", poses[:, :, :3], X) + poses[:, :, 3]
    z = Xc[:, 2]
    k = np.asarray(k, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = k[:, 0] * Xc[:, 0] / z + k[:, 2]
        v = k[:, 1] * Xc[:, 1] / z + k[:, 3]
        e = np.hypot(u - uv[:, 0], v - uv[:, 1]) / np.asarray(scale, np.float64)
    return np.where(z > 0, e, np.inf)
