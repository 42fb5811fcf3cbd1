"""Tracker: two-view bootstrap, PnP tracking with projection association
and relocalization (counterpart of `bootstrap`, `track`, `relocalize` and
their helpers in `monocular_slam_tpu/slam/tracker.py`).

Frame ids (`f0`, `f1` of `bootstrap`, `i` and `cand` of `relocalize`, `i`
of `track`) are host ints or 0-d device tensors: the session's captured
programs read them from device buffers, as the reference traces them.
Every quantity derived from the state stays on the device, and a failed
step returns the input state through `state.select`. Each step takes the
reference's key, as a host key (`utils/prng.py`) or as its (2,) int64
device words (`prng.key_on`), and draws what the reference draws from it;
`track` also takes the PnP key it would split off as device words
(`pnp_key`), and `u` takes the RANSAC uniforms themselves in place of the
key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import epipolar, pnp, se3, triangulate
from monocular_slam_tpu_torch.ops import matching
from monocular_slam_tpu_torch.optim import pose_ba, window_ba
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.config import SlamConfig
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils import prng
from monocular_slam_tpu_torch.utils.scatter import (
    index1, mark, put, segment_min, set_last, set_last_2d, take, topk_stable,
)


class BootstrapResult(NamedTuple):
    state: SlamState
    ok: torch.Tensor
    n_inliers: torch.Tensor
    n_points: torch.Tensor


def bootstrap(state: SlamState, key, cfg: SlamConfig, f0: int = 0, f1: int = 1,
              u=None) -> BootstrapResult:
    """Two-view initialization between frames f0 and f1: match -> RANSAC F
    -> E -> cheirality pose -> DLT -> two-view BA -> map points observed in
    both frames. `u`: the (ransac_iters, N) RANSAC uniforms in place of
    `key`."""
    s0 = state_mod.slot_index(state, f0)
    s1 = state_mod.slot_index(state, f1)
    kv0, kv1 = take(state.kp_valid, s0), take(state.kp_valid, s1)
    m = matching.match(
        take(state.desc_pm1, s0), take(state.desc_pm1, s1), kv0, kv1,
        ratio=cfg.frontend.match_ratio_init, max_dist=cfg.frontend.max_hamming,
    )
    uv0 = take(state.kp_uv, s0)
    uv1_all = take(state.kp_uv, s1)
    uv1 = uv1_all[m.idx.long()]
    k0, k1 = take(state.k, f0), take(state.k, f1)

    res = epipolar.ransac_fundamental(
        key, uv0, uv1, m.ok, n_iters=cfg.init.ransac_iters,
        thresh=cfg.init.sampson_px, u=u,
    )
    E = epipolar.essential_from_fundamental(res.F, k0, k1)
    tv = epipolar.pose_from_essential(E, k0, k1, uv0, uv1, res.inliers)
    T0 = take(state.poses, f0)
    T1 = se3.compose(tv.T_21, T0)
    X_world = se3.apply(se3.inverse(T0), tv.points)
    want = tv.good

    # two-view BA refinement on the candidate structure
    N = uv0.shape[0]
    dev = uv0.device
    ar = torch.arange(N, dtype=torch.int32, device=dev)
    f1_slot = set_last(torch.full((N,), N, dtype=torch.int32, device=dev),
                       torch.where(want, m.idx, N), ar)
    prob = window_ba.build(
        poses=torch.stack([T0, T1]),
        points=X_world,
        k=torch.stack([k0, k1]),
        pt_slot=torch.stack([ar, torch.clamp(f1_slot, max=N - 1)]),
        uv=torch.stack([uv0, uv1_all]),
        info=torch.stack([1.0 / take(state.kp_scale, s0), 1.0 / take(state.kp_scale, s1)]),
        valid=torch.stack([want & kv0, (f1_slot < N) & kv1]),
        fixed=torch.arange(2, device=dev) == 0,
    )
    bres = window_ba.bundle_adjust(prob, n_iters=cfg.init.refine_iters, delta=cfg.ba.huber_full)
    T1 = bres.poses[1]
    X_world = bres.points

    # re-gate on the refined geometry
    Xc0 = se3.apply(T0, X_world)
    Xc1 = se3.apply(T1, X_world)
    e0 = torch.linalg.norm(cam.project(k0, Xc0) - uv0, dim=-1)
    e1 = torch.linalg.norm(cam.project(k1, Xc1) - uv1, dim=-1)
    par = triangulate.parallax_cosine(T0, T1, X_world)
    want = (
        want
        & (Xc0[:, 2] > cfg.track.min_depth)
        & (Xc1[:, 2] > cfg.track.min_depth)
        & (e0 < cfg.init.refine_px_thresh)
        & (e1 < cfg.init.refine_px_thresh)
        & (par < cfg.init.max_cos_parallax)
    )
    n_strong = (want & (par < cfg.init.strong_cos_parallax)).sum()

    new_state, slot_ids = state_mod.allocate_points(state, X_world, want)
    feat_point = new_state.feat_point
    fp0 = torch.where(slot_ids >= 0, slot_ids, take(feat_point, s0))
    feat_point = put(feat_point, s0, fp0)
    fp1 = set_last(take(feat_point, s1), torch.where(slot_ids >= 0, m.idx, N), slot_ids)
    feat_point = put(feat_point, s1, fp1)

    ok = (
        (res.num_inliers >= cfg.init.min_inliers)
        & (tv.n_good >= cfg.init.min_inliers)
        & (n_strong >= cfg.init.min_strong_parallax)
    )
    pose_valid = put(put(new_state.pose_valid, f0, ok), f1, ok)
    new_state = new_state._replace(poses=put(new_state.poses, f1, T1), pose_valid=pose_valid,
                                   feat_point=feat_point)
    final = state_mod.select(ok, new_state, state)
    return BootstrapResult(final, ok, res.num_inliers, (slot_ids >= 0).sum())


class RelocResult(NamedTuple):
    state: SlamState
    ok: torch.Tensor
    n_inliers: torch.Tensor


def relocalize(state: SlamState, i: int, cand: int, key, cfg: SlamConfig, u=None) -> RelocResult:
    """Re-acquire lost frame i against keyframe `cand` (chosen on the host
    by BoW score): descriptor match through K2 -> the candidate's map
    associations -> PnP RANSAC -> GN motion-only refine. Writes the pose
    and the inlier associations. `u`: the (pnp_iters, N) uniforms in place
    of `key`."""
    si = state_mod.slot_index(state, i)
    sc = state_mod.slot_index(state, cand)
    cand_ok = (take(state.slot_of, cand) >= 0) & take(state.pose_valid, cand)
    m = matching.match(
        take(state.desc_pm1, si).contiguous(), take(state.desc_pm1, sc).contiguous(),
        take(state.kp_valid, si), take(state.kp_valid, sc) & cand_ok,
        ratio=cfg.frontend.match_ratio_init, max_dist=cfg.frontend.max_hamming,
        use_kernel=True,
    )
    pid = take(state.feat_point, sc)[m.idx.long()]
    pids = torch.clamp(pid, min=0).long()
    has = m.ok & (pid >= 0) & state.point_valid[pids]
    X = state.points[pids]
    uv_i = take(state.kp_uv, si)
    k_i = take(state.k, i)
    pres = pnp.solve_pnp_ransac(
        key, X, uv_i, k_i, has & take(state.kp_valid, si), n_iters=cfg.track.pnp_iters,
        px_thresh=cfg.track.pnp_px_thresh, min_inliers=cfg.track.reloc_min_inliers, u=u,
    )
    rres = pose_ba.refine_pose(pres.T, X, uv_i, k_i, (pres.inliers & has).to(uv_i.dtype),
                               n_rounds=3, solver="gn")
    n = torch.maximum(pres.n_inliers, rres.n_inliers)
    ok = (n >= cfg.track.reloc_min_inliers) & cand_ok
    use_ref = rres.n_inliers >= pres.n_inliers
    inl = torch.where(use_ref, rres.inliers, pres.inliers) & has
    fp_i = torch.where(inl, pid, take(state.feat_point, si))
    new_state = state._replace(poses=put(state.poses, i, torch.where(use_ref, rres.T, pres.T)),
                               pose_valid=put(state.pose_valid, i, True),
                               feat_point=put(state.feat_point, si, fp_i))
    return RelocResult(state_mod.select(ok, new_state, state), ok, n)


class TrackResult(NamedTuple):
    state: SlamState
    ok: torch.Tensor
    n_pnp_inliers: torch.Tensor
    n_new_points: torch.Tensor


def _window_frames(state: SlamState, i, cfg: SlamConfig):
    """(B,) the B most recent tracked, slot-resident frames before i,
    newest first, and their validity."""
    B = cfg.track.back_traverse
    F = state.poses.shape[0]
    idx = torch.arange(F, dtype=torch.int32, device=state.poses.device)
    score = torch.where(state.pose_valid & (state.slot_of >= 0) & (idx < i), idx, -1)
    js = torch.topk(score, B).values
    return torch.clamp(js, min=0).long(), js >= 0


def _window_matches(state: SlamState, i, cfg: SlamConfig, use_kernel: bool | None = None):
    """Frame i matched against each frame of its back-traverse window, as
    one batched match: idx/ok (B, N). On the card that is K2 in two
    launches; `use_kernel` forces a route (`matching.match`)."""
    js_safe, js_ok = _window_frames(state, i, cfg)
    si = state_mod.slot_index(state, i)
    sjs = state_mod.slot_index(state, js_safe)
    m = matching.match(
        take(state.desc_pm1, si),
        state.desc_pm1[sjs],
        take(state.kp_valid, si),
        state.kp_valid[sjs] & js_ok[:, None] & state.pose_valid[js_safe][:, None],
        ratio=cfg.frontend.match_ratio_track,
        max_dist=cfg.frontend.max_hamming,
        use_kernel=use_kernel,
    )
    return js_safe, js_ok, m


def _local_map_slab(state: SlamState, i, cfg: SlamConfig):
    """The map points seen by the back-traverse window plus the most
    covisible older resident frames, compacted into an (L,) slab with one
    representative descriptor each (its observation in the most recent
    window frame). Returns (slab_pid (L,), usable (L,), desc_l (L, 256))."""
    tcfg = cfg.track
    B = tcfg.back_traverse
    N = state.feat_point.shape[1]
    P = state.points.shape[0]
    L = min(tcfg.local_map_cap, P)
    dev = state.points.device

    js_safe, js_ok = _window_frames(state, i, cfg)
    C = tcfg.local_map_covis
    if C:
        F = state.poses.shape[0]
        ref_slot = state_mod.slot_index(state, js_safe[0])
        pid_ref = take(state.feat_point, ref_slot)
        active = mark(P, pid_ref, keep=(pid_ref >= 0) & take(state.kp_valid, ref_slot))
        pid_all = state.feat_point
        pa = torch.clamp(pid_all, min=0).long()
        hit = active[pa] & (pid_all >= 0) & state.kp_valid & state.point_valid[pa]
        cnt_slot = hit.to(torch.int32).sum(1)
        idxF = torch.arange(F, device=dev)
        in_window = (idxF[None, :] == js_safe[:, None]).any(0)
        cnt_f = torch.where(
            (state.slot_of >= 0) & state.pose_valid & (idxF < i) & ~in_window,
            cnt_slot[torch.clamp(state.slot_of, min=0).long()], -1,
        )
        cscore, jc = topk_stable(cnt_f, C)
        js_safe = torch.cat([js_safe, jc])
        js_ok = torch.cat([js_ok, cscore > 0])
        B = B + C
    sjs = state_mod.slot_index(state, js_safe)

    pid_win = state.feat_point[sjs]
    pw = torch.clamp(pid_win, min=0).long()
    win_valid = (pid_win >= 0) & state.kp_valid[sjs] & js_ok[:, None] & state.point_valid[pw]
    pid_seg = torch.where(win_valid, pid_win, P).reshape(-1).long()
    active = mark(P, pid_seg)
    rank = torch.cumsum(active.to(torch.int32), 0) - 1
    n_active = active.sum()
    slab_of = torch.where(active & (rank < L), rank, L)
    slab_pid = set_last(
        torch.zeros(L + 1, dtype=torch.int32, device=dev), slab_of,
        torch.arange(P, dtype=torch.int32, device=dev),
    )[:L].long()
    slab_used = torch.arange(L, device=dev) < torch.clamp(n_active, max=L)

    BIG = B * N
    flat = torch.arange(B * N, dtype=torch.int32, device=dev)
    obs_first = segment_min(
        torch.where(win_valid.reshape(-1), flat, BIG).to(torch.int32), pid_seg, P + 1
    )[:P]
    slab_first = obs_first[slab_pid]
    has_desc = slab_first < BIG
    sf = torch.clamp(slab_first, max=BIG - 1).long()
    desc_l = state.desc_pm1[sjs[sf // N], sf % N]
    return slab_pid, slab_used & has_desc, desc_l


def _project_associate(state: SlamState, i, T, fp_i, slab_pid, usable, desc_l,
                       radius_px: float, cfg: SlamConfig):
    """For each still-free feature of frame i, adopt the best descriptor
    match among slab points projecting within `radius_px` under pose T.
    Returns (fp_i', adopt (N,))."""
    tcfg = cfg.track
    Xc = se3.apply(T, state.points[slab_pid])
    uv_l = cam.project(take(state.k, i), Xc)
    W, H = cfg.image_wh
    vis = usable & (Xc[:, 2] > tcfg.min_depth) & cam.in_image(uv_l, W, H)
    si = state_mod.slot_index(state, i)
    free = take(state.kp_valid, si) & (fp_i < 0)
    d2 = ((take(state.kp_uv, si)[:, None, :] - uv_l[None, :, :]) ** 2).sum(-1)
    near = (d2 <= radius_px * radius_px) & vis[None, :] & free[:, None]
    ham = matching.hamming_matrix(take(state.desc_pm1, si), desc_l)
    gated = torch.where(near & (ham <= tcfg.local_max_hamming), ham, matching.BIG)
    best = torch.argmin(gated, dim=1)
    adopt = gated.gather(1, best[:, None])[:, 0] < matching.BIG
    return torch.where(adopt, slab_pid[best].to(fp_i.dtype), fp_i), adopt


def _predict_pose(state: SlamState, i) -> torch.Tensor:
    """Constant-velocity prediction from the previous two poses, anchored on
    the most recent valid pose."""
    F = state.poses.shape[0]
    dev = state.poses.device
    i = index1(i, dev)[0]
    iprev, ipp = torch.clamp(i - 1, min=0), torch.clamp(i - 2, min=0)
    ok_vel = take(state.pose_valid, iprev) & take(state.pose_valid, ipp) & (i >= 2)
    delta = se3.compose(take(state.poses, iprev), se3.inverse(take(state.poses, ipp)))
    delta = torch.where(ok_vel, delta, se3.identity(state.poses.dtype, device=dev))
    idx = torch.arange(F, device=dev)
    jlast = torch.argmax(torch.where(state.pose_valid & (idx < i), idx, -1))
    base = torch.where(take(state.pose_valid, iprev), take(state.poses, iprev),
                       take(state.poses, jlast))
    return se3.compose(delta, base)


def track(state: SlamState, i, key, cfg: SlamConfig, u=None, pnp_key=None) -> TrackResult:
    """PnP tracking of frame i (a host int or a 0-d device tensor) +
    new-point triangulation. PnP draws from the first half of
    `split(key)`, as in the reference; `pnp_key`: that half's words as a
    (2,) int64 device tensor (`prng.key_on`), in place of `key`; `u`: the
    (pnp_iters, N) PnP-RANSAC uniforms in place of either."""
    N = state.feat_point.shape[1]
    dtype = state.kp_uv.dtype
    si = state_mod.slot_index(state, i)
    uv_i = take(state.kp_uv, si)
    kv_i = take(state.kp_valid, si)
    k_i = take(state.k, i)
    js_safe, js_ok, m = _window_matches(state, i, cfg)
    sjs = state_mod.slot_index(state, js_safe)
    midx = m.idx.long()

    # 3D-2D association: nearest window frame with a candidate wins
    pid_w = torch.gather(state.feat_point[sjs], 1, midx)
    cand = m.ok & (pid_w >= 0)
    w_sel = torch.argmax(cand.to(torch.int32), dim=0)
    has = cand.any(0)
    pid = torch.gather(pid_w, 0, w_sel[None])[0]
    pid = torch.where(has, pid, -1)

    use_lm = cfg.track.track_local_map
    T_pred = _predict_pose(state, i)
    if use_lm:
        slab_pid, usable, desc_l = _local_map_slab(state, i, cfg)
        pid, _ = _project_associate(state, i, T_pred, pid, slab_pid, usable, desc_l,
                                    cfg.track.predict_radius_px, cfg)

    Xmap = state.points[torch.clamp(pid, min=0).long()]
    k_pnp = pnp_key if pnp_key is not None or key is None else prng.split(key)[0]
    pres = pnp.solve_pnp_ransac(
        k_pnp, Xmap, uv_i, k_i, (pid >= 0) & kv_i,
        n_iters=cfg.track.pnp_iters, px_thresh=cfg.track.pnp_px_thresh,
        min_inliers=cfg.track.pnp_min_inliers, T_init=T_pred, u=u,
    )
    T_i = pres.T
    fp_i = torch.where(pres.inliers & (pid >= 0), pid, take(state.feat_point, si))
    n_inliers = pres.n_inliers

    # track-local-map second pass on the PnP pose, then motion-only refine
    if use_lm:
        fp_i, adopt = _project_associate(state, i, T_i, fp_i, slab_pid, usable, desc_l,
                                         cfg.track.local_radius_px, cfg)
        assoc = (fp_i >= 0) & kv_i
        Xa = state.points[torch.clamp(fp_i, min=0).long()]
        rres = pose_ba.refine_pose(T_i, Xa, uv_i, k_i, assoc.to(dtype), n_rounds=3,
                                   solver="gn")
        use = rres.n_inliers >= pres.n_inliers
        T_i = torch.where(use, rres.T, T_i)
        fp_i = torch.where(adopt & use & ~rres.inliers, -1, fp_i)
        n_inliers = torch.where(use, rres.n_inliers, pres.n_inliers)
    ok = n_inliers >= cfg.track.pnp_min_inliers

    # new points from fresh match pairs, partnered with the FARTHEST window
    # frame that has one (longest baseline)
    fresh = m.ok & (pid_w < 0) & (fp_i[None, :] < 0)
    Bwin = fresh.shape[0]
    w_new = Bwin - 1 - torch.argmax(fresh.flip(0).to(torch.int32), dim=0)
    has_new = fresh.any(0)
    j_new = js_safe[w_new]
    prev_feat = torch.gather(midx, 0, w_new[None])[0]
    s_new = sjs[w_new]
    uv_prev = state.kp_uv[s_new, prev_feat]
    T_prev = state.poses[j_new]
    k_prev = state.k[j_new]
    X_new = triangulate.triangulate_dlt(
        triangulate.projection_matrix(k_prev, T_prev),
        triangulate.projection_matrix(k_i, T_i),
        uv_prev[:, None], uv_i[:, None],
    )[:, 0]

    Xc_prev = se3.apply(T_prev, X_new)
    Xc_cur = se3.apply(T_i, X_new)
    z_prev, z_cur = Xc_prev[:, 2], Xc_cur[:, 2]
    e_prev = torch.linalg.norm(cam.project(k_prev, Xc_prev) - uv_prev, dim=-1)
    e_cur = torch.linalg.norm(cam.project(k_i, Xc_cur) - uv_i, dim=-1)
    r1 = X_new - se3.camera_center(T_prev)
    r2 = X_new - se3.camera_center(T_i)[None, :]
    cospar = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
    tc = cfg.track
    want = (
        has_new & ok & kv_i
        & (z_prev > tc.min_depth) & (z_cur > tc.min_depth)
        & (z_prev < tc.max_depth) & (z_cur < tc.max_depth)
        & (e_cur < tc.triangulate_px_thresh) & (e_prev < tc.triangulate_px_thresh)
        & (cospar < tc.triangulate_max_cos_parallax)
    )
    new_state, slot_ids = state_mod.allocate_points(state, X_new, want)

    fp_i = torch.where(slot_ids >= 0, slot_ids, fp_i)
    feat_point = set_last_2d(new_state.feat_point, s_new, prev_feat, slot_ids,
                             keep=slot_ids >= 0)
    feat_point = put(feat_point, si, fp_i)
    new_state = new_state._replace(poses=put(new_state.poses, i, T_i),
                                   pose_valid=put(new_state.pose_valid, i, ok),
                                   feat_point=feat_point)
    final = state_mod.select(ok, new_state, state)
    return TrackResult(final, ok, n_inliers, (slot_ids >= 0).sum())
