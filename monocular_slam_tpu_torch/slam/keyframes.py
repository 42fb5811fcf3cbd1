"""Keyframe selection and redundant-keyframe culling (counterpart of
`monocular_slam_tpu/slam/keyframes.py`).

`cull_frames_device` is the reference's FrameCulling program and
`cull_keyframes` the session's pass. Both stay sequential over frames, as
the reference's `fori_loop` is, because each cull lowers the observation
counts the next decision sees, and neither reads the device on the host:
the session captures its pass into a CUDA graph. Frames that are not
culling candidates change nothing in the reference's loop, so the
session's pass makes a fixed trip over the padded keyframe list only.
"""

from __future__ import annotations

import numpy as np
import torch

from monocular_slam_tpu_torch.slam import mapping
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils.scatter import mark, put, segment_sum, take


def tracked_overlap(state: SlamState, i, j) -> torch.Tensor:
    """Fraction of frame i's associated points also observed in frame j."""
    C = mapping.covisibility(state)
    return C[i, j] / torch.clamp(C[i, i], min=1)


def select_keyframes(state: SlamState, n_frames: int, overlap_thresh: float = 0.7,
                     min_gap: int = 1, max_gap: int = 15) -> np.ndarray:
    """(F,) bool keyframe flags from the covisibility matrix (host loop)."""
    C = mapping.covisibility(state).cpu().numpy()
    valid = state.pose_valid.cpu().numpy()
    flags = np.zeros(state.poses.shape[0], bool)
    last_kf = None
    for i in range(int(n_frames)):
        if not valid[i]:
            continue
        if last_kf is None:
            flags[i] = True
            last_kf = i
            continue
        overlap = C[i, last_kf] / max(C[i, i], 1)
        if (overlap < overlap_thresh and i - last_kf >= min_gap) or (i - last_kf >= max_gap):
            flags[i] = True
            last_kf = i
    return flags


def _cull_pass(state: SlamState, order, flags, protect, active, redundancy: float,
               min_other_obs: int) -> torch.Tensor:
    """The reference's FrameCulling loop body over the frames `order` (T,),
    in that order, with no host read: step t decides frame order[t] when
    `active[t]` and the frame is a keyframe (`flags`), unprotected and
    resident (the reference's `considered`); any other step changes
    nothing. Returns the (F,) flags."""
    P = state.point_valid.shape[0]
    fp, kv, pv, slot_of = state.feat_point, state.kp_valid, state.point_valid, state.slot_of
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    contrib = valid & flags[cam_idx] & pv[pt_idx]
    counts = segment_sum(contrib.to(torch.int32), pt_idx, P)
    for t in range(order.shape[0]):
        f = order[t]
        sl = take(slot_of, f)
        resident = sl >= 0
        s = torch.clamp(sl, min=0)
        pids = take(fp, s)
        ps = torch.clamp(pids, min=0).long()
        ok = (pids >= 0) & take(kv, s) & pv[ps] & resident
        n_obs = ok.to(torch.int32).sum()
        well = ok & (counts[ps] >= min_other_obs + 1)
        frac = well.to(torch.int32).sum() / torch.clamp(n_obs, min=1)
        flag = take(flags, f)
        considered = active[t] & flag & ~take(protect, f) & resident
        cull = considered & ((n_obs == 0) | (frac >= redundancy))
        flags = put(flags, f, flag & ~cull)
        dec = (cull & ok).to(torch.int32)
        counts = counts - segment_sum(dec, torch.where(ok, pids, P), P)
    return flags


def cull_frames_device(state: SlamState, keyframes, protect, redundancy: float = 0.9,
                       min_other_obs: int = 3) -> torch.Tensor:
    """(F,) bool keyframe flags after FrameCulling, the reference's program:
    a fixed trip over every frame, in order; a resident, unprotected
    keyframe is culled when it has no observations or >= `redundancy` of
    them are seen by >= `min_other_obs` other keyframes. `keyframes` and
    `protect` are (F,) bool (numpy or tensors)."""
    dev = state.poses.device
    F = state.poses.shape[0]
    flags = torch.as_tensor(np.asarray(keyframes) if not torch.is_tensor(keyframes) else keyframes,
                            dtype=torch.bool, device=dev)
    protect = torch.as_tensor(np.asarray(protect) if not torch.is_tensor(protect) else protect,
                              dtype=torch.bool, device=dev)
    return _cull_pass(state, torch.arange(F, device=dev), flags, protect,
                      torch.ones(F, dtype=torch.bool, device=dev), redundancy, min_other_obs)


def cull_keyframes(state: SlamState, kf_pad: torch.Tensor, n_kf, keep_recent: int,
                   redundancy: float = 0.9, min_other_obs: int = 3) -> torch.Tensor:
    """The session's FrameCulling pass: `cull_frames_device` over the
    keyframe ids `kf_pad[:n_kf]` (ascending; the tail pads the list to a
    bucket), protecting the first and the `keep_recent` newest (all of them
    at `keep_recent` 0, as the host's `kfs[-0:]` does). Frames that are not
    keyframes change nothing in the reference's loop over every frame, so
    the fixed trip over the padded list, each step masked, decides as it
    does. `n_kf` is a host int or a 0-d device tensor. Returns the (F,)
    flags."""
    F = state.poses.shape[0]
    pos = torch.arange(kf_pad.shape[0], device=kf_pad.device)
    active = pos < n_kf
    newest = pos >= n_kf - keep_recent if keep_recent else torch.ones_like(active)
    flags = mark(F, kf_pad, keep=active)
    protect = mark(F, kf_pad, keep=active & ((pos == 0) | newest))
    return _cull_pass(state, kf_pad.long(), flags, protect, active, redundancy, min_other_obs)


def cull_frames(state: SlamState, keyframes: np.ndarray, redundancy: float = 0.9,
                min_other_obs: int = 3) -> np.ndarray:
    """Host version of the rule over keyframe ids in order (never culls the
    first keyframe); returns updated flags."""
    fp = state.feat_point.cpu().numpy()
    kv = state.kp_valid.cpu().numpy()
    pv = state.point_valid.cpu().numpy()
    slot_of = state.slot_of.cpu().numpy()
    P = pv.shape[0]
    flags = np.array(keyframes, bool)
    counts = np.zeros(P, np.int64)
    for j in np.where(flags)[0]:
        sj = slot_of[j]
        if sj >= 0:
            np.add.at(counts, fp[sj][(fp[sj] >= 0) & kv[sj]], 1)
    for i in np.where(flags)[0][1:]:
        si = slot_of[i]
        if si < 0:
            continue
        pids = fp[si][(fp[si] >= 0) & kv[si]]
        pids = pids[pv[pids]]
        if len(pids) == 0:
            flags[i] = False
            continue
        if (counts[pids] >= min_other_obs + 1).mean() >= redundancy:
            flags[i] = False
            np.subtract.at(counts, pids, 1)
    return flags
