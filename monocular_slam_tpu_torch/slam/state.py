"""SlamState — the fixed-capacity world state as a NamedTuple of tensors
(counterpart of `monocular_slam_tpu/slam/state.py`; same fields, shapes and
meaning).

Pose tier (F = max_frames, indexed by frame id), feature tier (S slots,
indexed by slot; `slot_of`/`frame_of` map between them) and map points
(P). The stages are functions state -> state' that return new tensors;
fields a stage does not touch are passed through as the same tensor.
`desc` holds the reference's uint32 words as int32 with the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from monocular_slam_tpu_torch.slam.config import SlamConfig
from monocular_slam_tpu_torch.utils.scatter import index1, set_last


class SlamState(NamedTuple):
    poses: torch.Tensor  # (F, 3, 4) world->camera
    pose_valid: torch.Tensor  # (F,) bool
    k: torch.Tensor  # (F, 4)
    kp_uv: torch.Tensor  # (S, N, 2) undistorted pixels
    kp_scale: torch.Tensor  # (S, N)
    kp_valid: torch.Tensor  # (S, N) bool
    desc: torch.Tensor  # (S, N, 8) int32 (uint32 bits)
    desc_pm1: torch.Tensor  # (S, N, 256) int8
    feat_point: torch.Tensor  # (S, N) int32 map point id or -1
    slot_of: torch.Tensor  # (F,) int32, -1 if evicted/none
    frame_of: torch.Tensor  # (S,) int32, -1 if free
    points: torch.Tensor  # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    n_points: torch.Tensor  # () int32 live map points
    n_frames: torch.Tensor  # () int32 frames ingested


_DTYPES = {
    "poses": torch.float32, "pose_valid": torch.bool, "k": torch.float32,
    "kp_uv": torch.float32, "kp_scale": torch.float32, "kp_valid": torch.bool,
    "desc": torch.int32, "desc_pm1": torch.int8, "feat_point": torch.int32,
    "slot_of": torch.int32, "frame_of": torch.int32, "points": torch.float32,
    "point_valid": torch.bool, "n_points": torch.int32, "n_frames": torch.int32,
}


def n_slots(cfg: SlamConfig) -> int:
    return cfg.max_slots if cfg.max_slots else cfg.max_frames


def empty_state(cfg: SlamConfig, device=None, dtype=torch.float32) -> SlamState:
    """The state of a session before its first frame; `dtype` is the float
    fields' type."""
    F, N, P = cfg.max_frames, cfg.frontend.n_features, cfg.max_points
    S = n_slots(cfg)
    fl = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    eye = torch.cat([torch.eye(3, **fl), torch.zeros((3, 1), **fl)], dim=1)
    return SlamState(
        poses=eye.repeat(F, 1, 1),
        pose_valid=torch.zeros(F, **b),
        k=torch.zeros((F, 4), **fl),
        kp_uv=torch.zeros((S, N, 2), **fl),
        kp_scale=torch.ones((S, N), **fl),
        kp_valid=torch.zeros((S, N), **b),
        desc=torch.zeros((S, N, 8), **i32),
        desc_pm1=torch.zeros((S, N, 256), dtype=torch.int8, device=device),
        feat_point=torch.full((S, N), -1, **i32),
        slot_of=torch.full((F,), -1, **i32),
        frame_of=torch.full((S,), -1, **i32),
        points=torch.zeros((P, 3), **fl),
        point_valid=torch.zeros(P, **b),
        n_points=torch.zeros((), **i32),
        n_frames=torch.zeros((), **i32),
    )


def state_from_numpy(d: dict, device=None) -> SlamState:
    """SlamState from numpy arrays keyed by the reference's field names
    (`desc` may be the reference's uint32; its bits are kept)."""
    out = {}
    for name, dt in _DTYPES.items():
        a = np.asarray(d[name])
        if name == "desc":
            a = a.astype(np.uint32).view(np.int32) if a.dtype != np.int32 else a
        out[name] = torch.from_numpy(np.array(a)).to(device=device, dtype=dt)
    return SlamState(**out)


def state_to_numpy(state: SlamState) -> dict:
    """Numpy arrays keyed by field name; `desc` as uint32, the reference's
    dtype."""
    out = {n: v.detach().cpu().numpy() for n, v in state._asdict().items()}
    out["desc"] = out["desc"].view(np.uint32)
    return out


def select(ok: torch.Tensor, new: SlamState, old: SlamState) -> SlamState:
    """Field-wise torch.where(ok, new, old); fields passed through
    unchanged (same tensor) are not copied."""
    return SlamState(*[
        n if n is o else torch.where(ok, n, o) for n, o in zip(new, old)
    ])


def slot_index(state: SlamState, frame_idx) -> torch.Tensor:
    """Clamped slot of a frame (0 if evicted); `frame_idx` is a host int or
    a device tensor of frame ids."""
    if torch.is_tensor(frame_idx):
        s = state.slot_of.index_select(0, frame_idx.reshape(-1).long())
        s = s.reshape(frame_idx.shape)
    else:
        s = state.slot_of[frame_idx]
    return torch.clamp(s, min=0).long()


def add_frame_features(state: SlamState, frame_idx, slot_idx, uv, scale,
                       valid, desc, desc_pm1, k) -> SlamState:
    """Write one frame's features into slot `slot_idx`, evicting the slot's
    previous occupant from the frame->slot map. `frame_idx` and `slot_idx`
    are host ints or 0-d device tensors."""
    dtype = state.kp_uv.dtype
    dev = state.kp_uv.device
    fi, si = index1(frame_idx, dev), index1(slot_idx, dev)
    old_frame = state.frame_of.index_select(0, si).long()
    slot_of = set_last(state.slot_of, old_frame, -1, keep=old_frame >= 0)

    def put(x, v):
        if not torch.is_tensor(v):
            v = torch.full(x.shape[1:], v, dtype=x.dtype, device=dev)
        return x.index_copy(0, si, v.to(x.dtype)[None])

    return state._replace(
        kp_uv=put(state.kp_uv, uv.to(dtype)),
        kp_scale=put(state.kp_scale, scale.to(dtype)),
        kp_valid=put(state.kp_valid, valid),
        desc=put(state.desc, desc),
        desc_pm1=put(state.desc_pm1, desc_pm1),
        feat_point=put(state.feat_point, -1),
        slot_of=slot_of.index_copy(0, fi, si.to(slot_of.dtype)),
        frame_of=state.frame_of.index_copy(0, si, fi.to(state.frame_of.dtype)),
        k=state.k.index_copy(0, fi, torch.as_tensor(k, dtype=dtype, device=dev)[None]),
        n_frames=torch.maximum(state.n_frames, (fi[0] + 1).to(state.n_frames.dtype)),
    )


def observation_edges(state: SlamState):
    """Flatten feat_point into (cam_idx, pt_idx, uv, info, valid) edge
    arrays of capacity S*N (cam_idx is the observing frame id)."""
    S, N = state.feat_point.shape
    fr = state.frame_of.long()
    cam_idx = torch.clamp(fr, min=0).repeat_interleave(N)
    pt_idx = state.feat_point.reshape(-1)
    uv = state.kp_uv.reshape(S * N, 2)
    info = (1.0 / state.kp_scale.reshape(-1)).to(state.kp_uv.dtype)
    valid = (
        (pt_idx >= 0)
        & state.kp_valid.reshape(-1)
        & (fr >= 0).repeat_interleave(N)
        & state.pose_valid[cam_idx]
    )
    return cam_idx, torch.clamp(pt_idx, min=0).long(), uv, info, valid


def allocate_points(state: SlamState, new_xyz: torch.Tensor, want: torch.Tensor):
    """Allocate up to sum(want) new map points into free slots, in rank
    order. Returns (state', slot_ids (M,) int32, -1 where not allocated)."""
    P = state.points.shape[0]
    M = want.shape[0]
    dev = want.device
    rank = torch.cumsum(want.to(torch.int32), 0) - 1
    free = ~state.point_valid
    frank = torch.cumsum(free.to(torch.int32), 0) - 1
    slot_of_rank = set_last(
        torch.full((M + 1,), P, dtype=torch.int32, device=dev),
        torch.where(free & (frank < M), frank, M),
        torch.arange(P, dtype=torch.int32, device=dev),
    )[:M]
    slots = slot_of_rank[torch.clamp(rank, 0, M - 1).long()]
    ok = want & (slots < P)
    points = set_last(state.points, slots, new_xyz.to(state.points.dtype), keep=ok)
    point_valid = set_last(state.point_valid, slots, True, keep=ok)
    state = state._replace(
        points=points,
        point_valid=point_valid,
        n_points=point_valid.to(torch.int32).sum().to(torch.int32),
    )
    return state, torch.where(ok, slots, -1).to(torch.int32)
