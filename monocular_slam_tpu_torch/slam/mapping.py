"""Local-mapping hygiene: observation bookkeeping, map-point culling,
projection-guided fuse, keyframe overlap and the covisibility graph
(counterpart of `monocular_slam_tpu/slam/mapping.py`). A frame id `i` is a
host int or a 0-d device tensor."""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.ops import matching
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils.scatter import mark, put, segment_min, segment_sum, set_last, take


def observation_counts(state: SlamState) -> torch.Tensor:
    """(P,) valid observations per map point."""
    _, pt_idx, _, _, valid = state_mod.observation_edges(state)
    return segment_sum(valid.to(torch.int32), pt_idx, state.points.shape[0])


def point_anchors(state: SlamState) -> torch.Tensor:
    """(P,) first observing frame per point (F if unobserved)."""
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    F = state.poses.shape[0]
    return segment_min(torch.where(valid, cam_idx, F).to(torch.int32), pt_idx,
                       state.points.shape[0])


def point_descriptors(state: SlamState):
    """Representative +-1 descriptor per point: its earliest slot-resident
    observation, ranked by observing frame id. Returns (desc (P, 256), has)."""
    S, N = state.feat_point.shape
    P = state.points.shape[0]
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    flat_id = torch.arange(S * N, dtype=torch.int32, device=cam_idx.device)
    key = cam_idx.to(torch.int32) * (S * N) + flat_id
    big = torch.iinfo(torch.int32).max
    first_key = segment_min(torch.where(valid, key, big), pt_idx, P)
    has = first_key < big
    first_safe = torch.where(has, first_key % (S * N), 0).long()
    return state.desc_pm1.reshape(S * N, -1)[first_safe], has


def cull_points(state: SlamState, i, min_obs: int = 3, grace: int = 3):
    """Invalidate points older than `grace` frames with fewer than
    `min_obs` observations and clear their feature associations.
    Returns (state', n_culled)."""
    counts = observation_counts(state)
    anchors = point_anchors(state)
    cull = state.point_valid & (anchors < (i - grace)) & (counts < min_obs)
    point_valid = state.point_valid & ~cull
    fp = state.feat_point
    dangling = cull[torch.clamp(fp, min=0).long()] & (fp >= 0)
    fp = torch.where(dangling, -1, fp)
    return (
        state._replace(point_valid=point_valid, feat_point=fp,
                       n_points=point_valid.to(torch.int32).sum().to(torch.int32)),
        cull.to(torch.int32).sum(),
    )


class FuseResult(NamedTuple):
    state: SlamState
    n_associated: torch.Tensor


def fuse(state: SlamState, i, radius_px: float = 4.0, max_hamming: int = 60,
         image_wh=(640, 480), slab_cap: int = 4096) -> FuseResult:
    """Features of frame i without a map point adopt the best projecting
    point within `radius_px` whose representative descriptor is within
    `max_hamming`. Candidates are compacted to <= slab_cap visible points."""
    P = state.points.shape[0]
    L = min(slab_cap, P)
    dev = state.points.device
    Xc = se3.apply(take(state.poses, i), state.points)
    uv_proj = cam.project(take(state.k, i), Xc)
    vis = state.point_valid & (Xc[:, 2] > 1e-3) & cam.in_image(uv_proj, image_wh[0], image_wh[1])
    pdesc, has_desc = point_descriptors(state)
    vis = vis & has_desc

    rank = torch.cumsum(vis.to(torch.int32), 0) - 1
    slab_of = torch.where(vis & (rank < L), rank, L)
    slab_pid = set_last(torch.zeros(L + 1, dtype=torch.int32, device=dev), slab_of,
                        torch.arange(P, dtype=torch.int32, device=dev))[:L].long()
    slab_used = torch.arange(L, device=dev) < torch.clamp(vis.sum(), max=L)
    uv_l = uv_proj[slab_pid]
    desc_l = pdesc[slab_pid]

    si = state_mod.slot_index(state, i)
    fp_si = take(state.feat_point, si)
    free = take(state.kp_valid, si) & (fp_si < 0)
    d2 = ((take(state.kp_uv, si)[:, None, :] - uv_l[None, :, :]) ** 2).sum(-1)
    near = (d2 <= radius_px * radius_px) & slab_used[None, :] & free[:, None]
    ham = matching.hamming_matrix(take(state.desc_pm1, si), desc_l)
    gated = torch.where(near & (ham <= max_hamming), ham, matching.BIG)
    best = torch.argmin(gated, dim=1)
    adopt = gated.gather(1, best[:, None])[:, 0] < matching.BIG
    fp_i = torch.where(adopt, slab_pid[best].to(fp_si.dtype), fp_si)
    state = state._replace(feat_point=put(state.feat_point, si, fp_i))
    return FuseResult(state, adopt.to(torch.int32).sum())


def frame_overlap(state: SlamState, i, j) -> torch.Tensor:
    """Fraction of frame i's associated points also observed by frame j."""
    si = state_mod.slot_index(state, i)
    sj = state_mod.slot_index(state, j)
    fp_i = take(state.feat_point, si)
    ok_i = (fp_i >= 0) & take(state.kp_valid, si)
    fp_j = take(state.feat_point, sj)
    ok_j = (fp_j >= 0) & take(state.kp_valid, sj)
    seen_j = mark(state.points.shape[0], fp_j, keep=ok_j)
    shared = (ok_i & seen_j[torch.clamp(fp_i, min=0).long()]).to(torch.int32).sum()
    return shared / torch.clamp(ok_i.to(torch.int32).sum(), min=1)


def _incidence_from(rows: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor, F: int, P: int):
    """(F, P) float32 0/1 incidence: max of `valid` over (row, point) pairs;
    rows outside [0, F) are dropped."""
    ok = (rows >= 0) & (rows < F)
    flat = torch.where(ok, rows.long() * P + pts.long(), F * P)
    inc = torch.zeros(F * P + 1, dtype=torch.float32, device=pts.device)
    inc = inc.scatter_reduce(0, flat, valid.to(torch.float32), "amax")
    return inc[: F * P].reshape(F, P)


def covisibility(state: SlamState) -> torch.Tensor:
    """(F, F) int32 shared-map-point counts between frames (rows of evicted
    frames are zero), as one incidence product (exact: 0/1 float32 inputs)."""
    F, P = state.poses.shape[0], state.points.shape[0]
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    inc = _incidence_from(cam_idx, pt_idx, valid, F, P)
    return (inc @ inc.T).to(torch.int32)


def _incidence(state: SlamState) -> torch.Tensor:
    """(F, P) 0/1 incidence of slot-resident observations of valid points."""
    N = state.feat_point.shape[1]
    F, P = state.poses.shape[0], state.points.shape[0]
    fp = state.feat_point
    resident = state.frame_of >= 0
    valid = (fp >= 0) & state.kp_valid & resident[:, None] & state.point_valid[torch.clamp(fp, min=0).long()]
    rows = torch.where(resident, state.frame_of, F).repeat_interleave(N)
    return _incidence_from(rows, torch.clamp(fp.reshape(-1), min=0), valid.reshape(-1), F, P)


def covisibility_row(state: SlamState, i) -> torch.Tensor:
    """(F,) int32 shared-map-point counts between frame i and every frame."""
    inc = _incidence(state)
    return (inc @ take(inc, i)).to(torch.int32)


def covisibility_window(state: SlamState, i, min_shared: int = 15) -> torch.Tensor:
    """(F,) bool: frames sharing >= min_shared points with frame i."""
    return (covisibility(state)[i] >= min_shared) & state.pose_valid
