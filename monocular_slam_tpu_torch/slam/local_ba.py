"""Windowed local bundle adjustment (counterpart of
`monocular_slam_tpu/slam/local_ba.py`): the W frames most covisible with
frame i (including it) are free, the next W are fixed anchors, and every map
point the window observes is free, compacted into a small slab and solved
on the (P, F) grid engine of `optim/window_ba.py`. The frame id `i` is a
host int or a 0-d device tensor."""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.optim import window_ba
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.config import SlamConfig
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils.scatter import index1, mark, put, set_last, take, topk_stable


class LocalBAResult(NamedTuple):
    state: SlamState
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor


def _covisibility_row(state: SlamState, i) -> torch.Tensor:
    """(F,) shared valid map points between frame i and every frame."""
    P = state.points.shape[0]
    F = state.poses.shape[0]
    si = state_mod.slot_index(state, i)
    fp_i = take(state.feat_point, si)
    seen = mark(P, fp_i, keep=(fp_i >= 0) & take(state.kp_valid, si))
    fp = state.feat_point
    resident = state.frame_of >= 0
    hit = (fp >= 0) & state.kp_valid & seen[torch.clamp(fp, min=0).long()] & resident[:, None]
    per_slot = hit.to(torch.int32).sum(1).to(torch.int32)
    row = torch.zeros(F + 1, dtype=torch.int32, device=fp.device)
    row.index_add_(0, torch.where(resident, state.frame_of, F).long(), per_slot)
    return row[:F]


def _select_window(state: SlamState, i, cfg: SlamConfig):
    """(g_safe (2W,), valid_frame (2W,), fixed (2W,)) of the active window."""
    W = cfg.ba.window
    F2 = 2 * W
    dev = state.poses.device
    slot = torch.arange(F2, device=dev)
    F = state.poses.shape[0]
    if cfg.ba.use_covisibility:
        row = _covisibility_row(state, i)
        idxF = torch.arange(F, device=dev)
        past = (idxF < i) & state.pose_valid & (state.slot_of >= 0)
        score = torch.where(past, row.to(torch.float32), -1.0)
        score = score + torch.arange(F, dtype=torch.float32, device=dev) / F
        score = put(score, torch.clamp(index1(i, dev)[0], min=0), 3e38)
        vals, g_safe = topk_stable(score, F2)
        valid_frame = (vals > 0.0) & state.pose_valid[g_safe]
        free = (slot < W) & valid_frame
    else:
        g_idx = (i - (F2 - 1)) + slot
        g_safe = torch.clamp(g_idx, min=0)
        valid_frame = (g_idx >= 0) & state.pose_valid[g_safe] & (state.slot_of[g_safe] >= 0)
        free = (slot >= W) & valid_frame
    fixed = ~free | (g_safe == 0)
    return g_safe, valid_frame, fixed


def local_bundle_adjust(state: SlamState, i, cfg: SlamConfig) -> LocalBAResult:
    N = state.feat_point.shape[1]
    F2 = 2 * cfg.ba.window
    dev = state.poses.device
    g_safe, valid_frame, fixed = _select_window(state, i, cfg)
    sg = state_mod.slot_index(state, g_safe)

    pt_slot = state.feat_point[sg]
    pt_safe = torch.clamp(pt_slot, min=0).long()
    valid = (pt_slot >= 0) & state.kp_valid[sg] & valid_frame[:, None] & state.point_valid[pt_safe]

    P = state.points.shape[0]
    P_BA = min(P, F2 * N, cfg.ba.local_max_points)
    active = mark(P, pt_slot.reshape(-1), keep=valid.reshape(-1))
    rank = torch.cumsum(active.to(torch.int32), 0) - 1
    n_active = active.sum()
    slab_of = torch.where(active & (rank < P_BA), rank, P_BA)
    inv = set_last(torch.zeros(P_BA + 1, dtype=torch.int32, device=dev), slab_of,
                   torch.arange(P, dtype=torch.int32, device=dev))
    points_slab = state.points[inv[:P_BA].long()]
    pt_local = slab_of[pt_safe]
    valid = valid & (pt_local < P_BA)
    pt_local = torch.clamp(pt_local, max=P_BA - 1)

    prob = window_ba.build(
        poses=state.poses[g_safe],
        points=points_slab,
        k=state.k[g_safe],
        pt_slot=pt_local,
        uv=state.kp_uv[sg],
        info=(1.0 / state.kp_scale[sg]).to(state.kp_uv.dtype),
        valid=valid,
        fixed=fixed,
    )
    res = window_ba.bundle_adjust(prob, n_iters=cfg.ba.local_iters, delta=cfg.ba.huber_full)

    poses = set_last(state.poses, g_safe, res.poses, keep=~fixed)
    slab_used = torch.arange(P_BA, device=dev) < n_active
    points = set_last(state.points, inv[:P_BA], res.points, keep=slab_used)
    return LocalBAResult(state._replace(poses=poses, points=points),
                         res.chi2_initial, res.chi2_history[-1])
