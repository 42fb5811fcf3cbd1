"""Synthetic SLAM sequences with exact ground truth (counterpart of
`monocular_slam_tpu/datasets/synthetic.py`).

- `arc_trajectory`: cameras orbiting the origin and looking at it;
- `feature_sequence`: a world point cloud with stable random ORB-like
  descriptors projected into the orbit with pixel noise, dropout and bit
  flips — frames of the port's `orb.Features` for
  `SlamSession.add_frame_features`;
- `textured_sequence`: images of a textured fronto-parallel plane under
  lateral and yaw motion.

The random draws come from `utils/prng.py` (threefry, as `jax.random`
draws them), so `feature_sequence(PRNGKey(s))` and
`textured_sequence(PRNGKey(s))` are the reference's data for the same key;
the geometry is float32 tensor math on the requested device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from monocular_slam_tpu_torch.geometry import camera, se3, so3
from monocular_slam_tpu_torch.ops import orb
from monocular_slam_tpu_torch.ops.pyramid import cubic_upsample
from monocular_slam_tpu_torch.utils import prng
from monocular_slam_tpu_torch.utils.device import resolve_device

TUM_K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)


class SyntheticSequence(NamedTuple):
    poses_gt: np.ndarray  # (F, 3, 4) world->camera
    points_gt: np.ndarray  # (P, 3)
    k: np.ndarray  # (4,)
    frames: list  # list of orb.Features on the device
    timestamps: np.ndarray  # (F,)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as XLA's fused multiply-add."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


def _norm(v: np.ndarray) -> np.ndarray:
    """|v| over the last axis of 3, accumulated as XLA's CPU reduction does."""
    return np.sqrt(_fma(v[..., 2], v[..., 2], _fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`jnp.cross` with the first product of each component fused."""
    comp = [_fma(a[..., i], b[..., j], -(a[..., j] * b[..., i])) for i, j in ((1, 2), (2, 0), (0, 1))]
    return np.stack(comp, axis=-1)


def arc_trajectory(n_frames: int, radius: float = 4.0, dtype=np.float32,
                   ang_step: float = 0.04) -> np.ndarray:
    """(n_frames, 3, 4) world->camera poses orbiting the origin and looking
    at it; a full revisit happens at ang_step * i = 2 pi. float32: float32
    arithmetic with the reference's fused multiply-adds, so the poses equal
    the reference's bit for bit; float64: plain float64 arithmetic (the
    reference's float64 multiply-adds round once, these twice)."""
    i = np.arange(n_frames)
    ang = ang_step * i
    c = np.stack([radius * np.sin(ang), 0.15 * np.sin(0.3 * i), -radius * np.cos(ang)], axis=-1)
    if np.dtype(dtype) == np.float64:
        z = -c / np.linalg.norm(c, axis=-1, keepdims=True)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        R_wc = np.stack([x, np.cross(z, x)], axis=1)
        R_wc = np.concatenate([R_wc, z[:, None]], axis=1)
        t = -(R_wc @ c[..., None])[..., 0]
        return np.concatenate([R_wc, t[..., None]], axis=-1)
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"arc_trajectory: dtype must be float32 or float64, got {dtype}")
    c = c.astype(np.float32)
    z = -c / _norm(c)[:, None]
    x = _cross(np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), z.shape), z)
    x = x / _norm(x)[:, None]
    y = _cross(z, x)
    R_wc = np.stack([x, y, z], axis=1)  # rows = camera axes in world
    t = -_fma(R_wc[..., 2], c[:, None, 2], _fma(R_wc[..., 1], c[:, None, 1],
                                                R_wc[..., 0] * c[:, None, 0]))
    return np.concatenate([R_wc, t[..., None]], axis=-1).astype(np.float32)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(..., 256) bool -> (..., 8) uint32, little-endian within each word."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


def feature_sequence(
    key,
    n_frames: int = 30,
    n_world_points: int = 800,
    n_features: int = 400,
    pix_noise: float = 0.3,
    drop_prob: float = 0.1,
    desc_flip_bits: int = 8,
    image_wh=(640, 480),
    k=TUM_K,
    ang_step: float = 0.04,
    device=None,
) -> SyntheticSequence:
    """Project a fixed world point cloud into an arc trajectory.

    `key` is a threefry key (`prng.PRNGKey(seed)`). Each world point has a
    persistent random descriptor; per frame, observations flip
    `desc_flip_bits` random bits and drop out with `drop_prob`, and the
    first `n_features` visible points fill the fixed-capacity Features.
    """
    dev = resolve_device(device)
    key = np.asarray(key, np.uint32)
    kw, kd = prng.split(key)
    pts = prng.uniform(kw, (n_world_points, 3), minval=-2.0, maxval=2.0)
    pts = pts * np.array([2.0, 1.5, 2.0], np.float32)
    poses = arc_trajectory(n_frames, ang_step=ang_step)
    W, H = image_wh
    desc_bits = prng.bernoulli(kd, 0.5, (n_world_points, 256))
    kt = torch.as_tensor(np.asarray(k, np.float32), device=dev)
    pts_t = torch.as_tensor(pts, device=dev)
    slot = torch.arange(n_features, device=dev)

    frames = []
    for i in range(n_frames):
        k1, k2, k3 = prng.split(prng.fold_in(key, 1000 + i), 3)
        Xc = se3.apply(torch.as_tensor(poses[i], device=dev), pts_t)
        uv = camera.project(kt, Xc)
        if pix_noise > 0:
            uv = uv + pix_noise * torch.as_tensor(prng.normal(k1, tuple(uv.shape)), device=dev)
        keep = torch.as_tensor(prng.uniform(k2, (n_world_points,)) > drop_prob, device=dev)
        vis = (Xc[:, 2] > 0.3) & camera.in_image(uv, W, H, margin=4.0) & keep
        order = torch.argsort((~vis).to(torch.uint8), stable=True)  # visible first
        if n_world_points < n_features:
            order = torch.cat([order, order.new_zeros(n_features - n_world_points)])
        sel = order[:n_features]
        valid = vis[sel] & (slot < n_world_points)
        bits = desc_bits[sel.cpu().numpy()]
        if desc_flip_bits > 0:
            flip_idx = prng.randint(k3, (n_features, desc_flip_bits), 0, 256)
            flips = np.zeros((n_features, 256), bool)
            np.put_along_axis(flips, flip_idx, True, axis=1)
            bits = bits ^ flips
        pm1 = bits.astype(np.int8) * 2 - 1
        frames.append(orb.Features(
            uv=uv[sel].to(torch.float32),
            desc=torch.as_tensor(_pack_bits(bits).view(np.int32), device=dev),
            desc_pm1=torch.as_tensor(pm1, device=dev),
            angle=torch.zeros(n_features, device=dev),
            score=torch.ones(n_features, device=dev),
            scale=torch.ones(n_features, device=dev),
            valid=valid,
        ))
    return SyntheticSequence(
        poses_gt=poses,
        points_gt=pts,
        k=np.asarray(k, np.float32),
        frames=frames,
        timestamps=np.arange(n_frames, dtype=np.float64) * (1.0 / 30.0),
    )


def textured_sequence(key, n_frames: int = 10, wh=(320, 240), device=None):
    """Images of a textured fronto-parallel plane under lateral+yaw motion.

    Returns (images list[(H, W) float32 tensor], poses_gt (F, 3, 4) numpy,
    k (4,) numpy). The plane is at constant depth — for frontend smoke
    tests.
    """
    dev = resolve_device(device)
    W, H = wh
    k = np.array([260.0, 260.0, W / 2.0, H / 2.0], np.float32)
    kt = torch.as_tensor(k, device=dev)
    tex = torch.as_tensor(prng.uniform(np.asarray(key, np.uint32), (64, 64)) * np.float32(255.0),
                          device=dev)
    tex = torch.clamp(cubic_upsample(tex, (512, 512)), 0.0, 255.0)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    xy = camera.normalize_points(kt, torch.stack([xs, ys], dim=-1).to(torch.float32))
    ray = torch.cat([xy, torch.ones((H, W, 1), device=dev)], dim=-1)

    images, poses = [], []
    depth = 3.0
    for i in range(n_frames):
        R = so3.exp(torch.tensor([0.0, 0.01 * i, 0.0], device=dev))
        T = se3.from_Rt(R, torch.tensor([-0.05 * i, 0.0, 0.0], device=dev))  # world->camera
        poses.append(T)
        # inverse warp: each pixel's ray meets the plane z = depth (world)
        C = se3.camera_center(T)
        dirs = ray @ T[:3, :3]  # world-frame ray directions
        lam = (depth - C[2]) / dirs[..., 2]
        Xw = C + lam[..., None] * dirs
        # world x, y in [-2, 2] -> texture coordinates
        u = (Xw[..., 0] + 2.0) / 4.0 * 511.0
        v = (Xw[..., 1] + 2.0) / 4.0 * 511.0
        ui = torch.clamp(u.to(torch.int32), 0, 511).long()
        vi = torch.clamp(v.to(torch.int32), 0, 511).long()
        images.append(tex[vi, ui])
    return images, torch.stack(poses).cpu().numpy(), k
