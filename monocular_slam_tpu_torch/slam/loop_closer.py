"""Loop closure: BoW detection -> Sim3 -> keyframe pose graph -> global BA
(counterpart of `monocular_slam_tpu/slam/loop_closer.py`).

Per frame, `detect_step` runs on the device inside the session's step:
BoW transform of the frame's descriptors, one L1 score against the whole
(max_frames, V) database, the temporal, insertion and (optionally)
covisibility gates, the similarity floor, and at keyframes the row insert.
Its four scalars ride in the session's packed per-frame vector and are read
`stat_lag` frames later, as in the reference.

On the host, at keyframe rate: the consistency check over detections
(`offer`); on a consistent candidate, `close`: the Sim3 from K2 matches
(`compute_sim3`), the near-identity gate, the pose-graph correction with
every remembered loop edge (`correct`), the global BA, and the chi2
quality guard. Those read a few scalars on the host, at closure rate.
Keyframe graphs past `POSE_GRAPH_DENSE_MAX` vertices (512; the reference:
128) take the matrix-free `pose_graph.optimize_cg`, and global BA past F*P =
4e6 takes `cg_ba.bundle_adjust_cg`, as in the reference; they run
`POSE_GRAPH_CG_ITERS` and `GLOBAL_BA_CG_ITERS` PCG steps per LM iteration
(the reference 100 and 50).

The database row insert updates `db` in place (the reference returns a new
array); the session owns the one database tensor.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from monocular_slam_tpu_torch.geometry import alignment
from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.geometry import se3 as se3_mod
from monocular_slam_tpu_torch.geometry import sim3
from monocular_slam_tpu_torch.ops import matching
from monocular_slam_tpu_torch.optim import ba as ba_mod
from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
from monocular_slam_tpu_torch.retrieval import vocabulary as vocab_mod
from monocular_slam_tpu_torch.slam import mapping
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.config import SlamConfig
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils.device import resolve_device
from monocular_slam_tpu_torch.utils.scatter import index1, mark, segment_min, set_last, take

# PCG steps per LM iteration of the CG routes. The reference runs 50 (global
# BA) and 100 (pose graph). On its own rendered revisit course
# (chip_smoke.py's loop state, perturbed) those counts end 10% and 13% of
# the dense route's correction away from it; 100 and 200 steps end 0.4%
# and 1.4% away (chip_profile.py cgdense, H100). At the closures of the
# 1000-frame long run (chip_profile.py cgdense long) 100 steps keep global
# BA within 0.6% of the dense Schur at F 1032, but the pose graph at K_pad
# 256-512 needs more: 200 steps end 7-33% of the dense correction away, 400
# up to 11%, 800 at most 0.5% (a chain's conditioning, not float32: float64
# at 200 steps ends as far away), so the CG pose graph runs 800. Those
# graphs take the exact dense route, 1.3-1.9 s a correction at K_pad 512
# against ~13 s for 800 PCG steps, so the dense route runs up to 512 (the
# reference switches at 128); larger graphs, no better conditioned, keep
# the CG route at 800 steps.
GLOBAL_BA_CG_ITERS = 100
POSE_GRAPH_CG_ITERS = 800
POSE_GRAPH_DENSE_MAX = 512


@dataclass
class LoopClosureConfig:
    """The reference's loop-closure settings and defaults (its comments
    record why each value was chosen)."""

    min_gap: int = 15  # frames between query and candidate
    min_score: float = 0.08  # absolute BoW score gate
    margin: float = 0.06  # best must beat the database median by this much
    consistency: int = 2  # consecutive keyframe queries agreeing on a place
    neighborhood: int = 5  # candidate advance slack: |dj| <= dq + neighborhood
    min_covis: int = 0  # exclude candidates sharing >= this many points (0: off)
    sim3_iters: int = 256
    sim3_guided: bool = False  # node-equality-masked matching (DBoW2 direct index)
    sim3_guided_levels_up: int = 2
    sim3_px_thresh: float = 10.0  # Sim3 inlier gate, reprojection pixels
    sim3_min_inliers: int = 15
    run_global_ba: bool = True
    global_ba_iters: int = 10
    cooldown: int = 20  # frames to wait after a closure
    id_rot_rad: float = 0.1  # near-identity gate: skip the correction below
    id_trans: float = 0.05  # all three drift thresholds
    id_log_scale: float = 0.01
    max_loop_edges: int = 32  # remembered closure constraints (FIFO)
    loop_edge_weight: float = 20.0  # graph weight of a corrected closure
    near_id_edge_weight: float = 5.0  # graph weight of a skip-path closure
    kf_bucket: int = 128  # keyframe-graph pad bucket
    pg_huber_delta: float = 1.0  # Huber delta on pose-graph odometry edges
    graph_all_frames: bool = False  # span the graph over every valid frame


class DetectOut(NamedTuple):
    best_j: torch.Tensor  # int32 candidate frame, -1 if none eligible
    score: torch.Tensor  # float32 best BoW score
    floor: torch.Tensor  # float32 similarity floor (median of eligible)
    n_cand: torch.Tensor  # int32 eligible candidates


def null_detect_out(device=None) -> DetectOut:
    """The detection outputs of a frame that was not queried."""
    return DetectOut(torch.full((), -1, dtype=torch.int32, device=device),
                     torch.zeros((), device=device), torch.zeros((), device=device),
                     torch.zeros((), dtype=torch.int32, device=device))


def _select_candidate(scores, eligible):
    """Best eligible row, its score, the similarity floor (median of the
    eligible scores for >= 3 candidates, else their minimum) and the count."""
    n_cand = eligible.to(torch.int32).sum()
    sc = torch.where(eligible, scores, -torch.inf)
    best_j = torch.argmax(sc)
    sorted_sc = torch.sort(torch.where(eligible, scores, torch.inf)).values
    med = take(sorted_sc, torch.clamp((n_cand - 1) // 2, min=0))
    floor = torch.where(n_cand >= 3, med, sorted_sc[0])
    ok = n_cand > 0
    return DetectOut(
        torch.where(ok, best_j, -1).to(torch.int32),
        torch.where(ok, take(sc, best_j), 0.0).to(torch.float32),
        torch.where(ok, floor, 0.0).to(torch.float32),
        n_cand.to(torch.int32),
    )


def detect_step(voc: vocab_mod.Vocabulary, lc: LoopClosureConfig, db: torch.Tensor,
                state: SlamState, i: int, is_kf) -> tuple[torch.Tensor, DetectOut]:
    """Keyframe-gated loop detection for frame i: BoW vector, L1 scores
    against every database row, eligibility (inserted rows at least
    `min_gap` frames back, optionally not covisible), candidate and floor;
    row i takes the frame's vector when `is_kf` (a host bool, or a device
    bool that is then applied without a sync). Returns (db, DetectOut);
    `db` is updated in place."""
    sl = state_mod.slot_index(state, i)
    q = vocab_mod.bow_vector(voc, take(state.desc_pm1, sl), take(state.kp_valid, sl))
    scores = vocab_mod.score_l1(q[None, :], db)
    rows = torch.arange(db.shape[0], device=db.device)
    eligible = (db.abs().sum(-1) > 0.5) & (rows <= i - lc.min_gap)
    if lc.min_covis:
        eligible = eligible & (mapping.covisibility_row(state, i) < lc.min_covis)
    det = _select_candidate(scores, eligible)
    if torch.is_tensor(is_kf):
        db.index_copy_(0, index1(i, db.device), torch.where(is_kf, q, take(db, i))[None])
    elif is_kf:
        db[i] = q
    return db, det


def _mean_obs_chi2(state: SlamState) -> torch.Tensor:
    """Mean Huber (delta^2 = 5.99) reprojection chi2 over every valid
    observation: the closure quality guard's map-consistency scalar."""
    cam_idx, pt_idx, uv, info, valid = state_mod.observation_edges(state)
    Xc = se3_mod.apply(state.poses[cam_idx], state.points[pt_idx])
    pred = cam.project(state.k[cam_idx], Xc)
    ok = valid & (Xc[..., 2] > 1e-3)
    d = torch.where(ok[:, None], pred - uv, 0.0)
    e2 = (d * d).sum(-1) * info
    delta2 = 5.99
    rho = torch.where(e2 <= delta2, e2, 2.0 * torch.sqrt(delta2 * torch.clamp(e2, min=1e-12)) - delta2)
    return torch.where(ok, rho, 0.0).sum() / torch.clamp(ok.to(torch.int32).sum(), min=1)


def _orthonormal(T: torch.Tensor) -> torch.Tensor:
    """Poses (..., 3, 4) with each rotation block projected back onto SO(3).
    The corrections compose a pose with another pose's transpose taken as
    its inverse, so a rotation's departure from orthonormality roughly
    triples at every correction: over the 14 closures of a 1000-frame run
    on an H100 it reached keyframe determinants of 0.7-1.35 and camera
    centres of 1e18. The reference composes the same way without this
    projection; on rigid input it changes a pose by rounding only.
    Non-finite poses come back as the identity (the callers refuse them)."""
    good = torch.isfinite(T).all(-1).all(-1)[..., None, None]
    eye = se3_mod.identity(dtype=T.dtype, device=T.device)
    return se3_mod.normalize(torch.where(good, T, eye))


def _ref_positions(in_kf: torch.Tensor, kf_pos: torch.Tensor) -> torch.Tensor:
    """For every frame, the graph position of its reference keyframe (the
    most recent keyframe at or before it; 0 before the first)."""
    ref = torch.cummax(torch.where(in_kf, kf_pos, -1), dim=0).values
    return torch.clamp(ref, min=0).long()


class LoopCloser:
    """Loop-closure component over a `SlamSession`'s state. The session runs
    `detect_step` per frame and calls `offer`/`close` with its outputs; the
    standalone `add_frame`/`detect`/`run` host API is kept for direct use."""

    def __init__(self, voc: vocab_mod.Vocabulary, cfg: SlamConfig,
                 lc: LoopClosureConfig | None = None, device=None):
        self.voc = voc
        self.cfg = cfg
        self.lc = lc if lc is not None else LoopClosureConfig()
        self.device = resolve_device(device)
        self._db = torch.zeros((cfg.max_frames, voc.n_words), dtype=torch.float32,
                               device=self.device)
        self._hits: list[tuple[int, int]] = []
        self._cooldown_until = -1
        self.closures: list[tuple[int, int]] = []
        self.corrected: list[tuple[int, int]] = []
        self.skipped_identity: list[tuple[int, int]] = []
        self.reverted: list[tuple[int, int]] = []
        # remembered loop constraints (i, j, S_meas (3, 5) numpy, weight)
        self.loop_edges: list[tuple[int, int, np.ndarray, float]] = []
        self.timings: dict = {"bow": 0.0, "detect": 0.0, "sim3": 0.0,
                              "pose_graph": 0.0, "global_ba": 0.0, "n_runs": 0}

    # --- small device helpers -------------------------------------------------
    def _bow_of(self, state: SlamState, i: int) -> torch.Tensor:
        sl = state_mod.slot_index(state, i)
        return vocab_mod.bow_vector(self.voc, take(state.desc_pm1, sl), take(state.kp_valid, sl))

    def insert_from_state(self, state: SlamState, i: int) -> None:
        self._db[i] = self._bow_of(state, i)

    def clear_rows(self, rows) -> None:
        """Zero the database rows of culled keyframes."""
        rows = torch.as_tensor(list(rows), dtype=torch.long, device=self.device)
        self._db.index_fill_(0, rows, 0.0)

    def reloc_scores(self, state: SlamState, i: int) -> torch.Tensor:
        """(F,) BoW scores of frame i against inserted rows (-inf elsewhere)."""
        scores = vocab_mod.score_l1(self._bow_of(state, i)[None, :], self._db)
        return torch.where(self._db.abs().sum(-1) > 0.5, scores, -torch.inf)

    @staticmethod
    def _slot(state: SlamState, f: int) -> int | None:
        sl = int(state.slot_of[f])
        return sl if sl >= 0 else None

    # --- standalone host API ----------------------------------------------------
    def add_frame(self, state: SlamState, i: int, q=None) -> None:
        """Set database row i (idempotent)."""
        if q is None:
            if self._slot(state, i) is None:
                return
            self.insert_from_state(state, i)
        else:
            self._db[i] = q

    def detect(self, i: int, q=None) -> Optional[int]:
        """Candidate frame for frame i against rows < i - min_gap, or None."""
        if q is None:
            q = self._db[i]
        rows = torch.arange(self._db.shape[0], device=self.device)
        eligible = (self._db.abs().sum(-1) > 0.5) & (rows <= i - self.lc.min_gap) & (rows < i)
        det = _select_candidate(vocab_mod.score_l1(q[None, :], self._db), eligible)
        return self.offer(i, int(det.best_j), float(det.score), float(det.floor), int(det.n_cand))

    # --- consistency gate -----------------------------------------------------
    def offer(self, i: int, best_j: int, score: float, floor: float, n_cand: int) -> Optional[int]:
        """Host consistency check over keyframe-rate detections; the frame to
        close against, or None."""
        lc = self.lc
        if i < lc.min_gap or i < self._cooldown_until or n_cand <= 0:
            return None
        if best_j < 0 or score < lc.min_score or score < floor + lc.margin:
            self._hits.append((i, -1))
            return None
        self._hits.append((i, best_j))
        recent = self._hits[-lc.consistency:]
        if len(recent) < lc.consistency:
            return None
        for (fa, ja), (fb, jb) in zip(recent, recent[1:]):
            if ja < 0 or jb < 0:
                return None
            if abs(jb - ja) > (fb - fa) + lc.neighborhood:
                return None
        return best_j

    # --- Sim3 -------------------------------------------------------------------
    def compute_sim3(self, state: SlamState, i: int, j: int, key, u=None):
        """Sim3 aligning frame i's map geometry to frame j's through K2
        descriptor matches whose features both carry map points. Returns
        (S (3, 5), n_inliers) or (None, n_inliers). `key`: the RANSAC's
        host key; `u`: its (sim3_iters, N) uniforms in place of `key`."""
        sl_i, sl_j = self._slot(state, i), self._slot(state, j)
        if sl_i is None or sl_j is None:
            return None, 0
        a, b = state.desc_pm1[sl_i], state.desc_pm1[sl_j]
        av, bv = state.kp_valid[sl_i], state.kp_valid[sl_j]
        if self.lc.sim3_guided:
            up = self.lc.sim3_guided_levels_up
            m = matching.guided_match(
                a, b, av, bv, vocab_mod.node_words(self.voc, a, av, levels_up=up),
                vocab_mod.node_words(self.voc, b, bv, levels_up=up),
                ratio=0.9, max_dist=self.cfg.frontend.max_hamming,
            )
        else:
            m = matching.match(a, b, av, bv, ratio=0.9, max_dist=self.cfg.frontend.max_hamming,
                               use_kernel=True)
        idx = m.idx.long()
        pid_i = state.feat_point[sl_i]
        pid_j = state.feat_point[sl_j][idx]
        ok = m.ok & (pid_i >= 0) & (pid_j >= 0)
        res = alignment.ransac_sim3_reproj(
            key, state.points[torch.clamp(pid_i, min=0).long()],
            state.points[torch.clamp(pid_j, min=0).long()], ok,
            state.kp_uv[sl_i], state.kp_uv[sl_j][idx], state.k[i], state.k[j],
            state.poses[i], state.poses[j], n_iters=self.lc.sim3_iters,
            px_thresh=self.lc.sim3_px_thresh, min_inliers=self.lc.sim3_min_inliers, u=u,
        )
        ok_n = torch.stack([res.ok.to(torch.int64), res.n_inliers.to(torch.int64)]).tolist()
        if not ok_n[0]:
            return None, ok_n[1]
        return res.S, ok_n[1]

    # --- loop-edge memory ---------------------------------------------------------
    def _record_edge(self, state: SlamState, i: int, j: int, S_align, weight: float) -> None:
        """Remember S_meas_ij = (T_i o S^-1) o T_j^-1."""
        T_i_corr = sim3.compose(sim3.from_se3(state.poses[i]), sim3.inverse(S_align))
        meas = sim3.compose(T_i_corr, sim3.inverse(sim3.from_se3(state.poses[j])))
        self.loop_edges.append((i, j, meas.cpu().numpy(), weight))
        if len(self.loop_edges) > self.lc.max_loop_edges:
            self.loop_edges.pop(0)

    def drop_edges_for(self, frames) -> None:
        gone = set(frames)
        self.loop_edges = [e for e in self.loop_edges if e[0] not in gone and e[1] not in gone]

    # --- closure -------------------------------------------------------------------
    def close(self, state: SlamState, i: int, j: int, key, keyframes, u=None):
        """ComputeSim3 -> near-identity gate -> CorrectLoop -> quality guard.
        Returns (state, closed?)."""
        self.timings["n_runs"] += 1
        t0 = time.perf_counter()
        S, _ = self.compute_sim3(state, i, j, key, u=u)
        self.timings["sim3"] += time.perf_counter() - t0
        if S is None:
            return state, False
        lc = self.lc
        xi = sim3.log(S).cpu().numpy()
        if (float(np.linalg.norm(xi[3:6])) < lc.id_rot_rad
                and float(np.linalg.norm(xi[0:3])) < lc.id_trans
                and abs(float(xi[6])) < lc.id_log_scale):
            self._record_edge(state, i, j, S, lc.near_id_edge_weight)
            self.closures.append((i, j))
            self.skipped_identity.append((i, j))
            self._cooldown_until = i + lc.cooldown
            self._hits.clear()
            return state, True
        t0 = time.perf_counter()
        pre_state = state
        chi2_pre = _mean_obs_chi2(state)
        state, applied = self.correct(state, i, j, S, keyframes=keyframes)
        if not applied:
            self.timings["pose_graph"] += time.perf_counter() - t0
            return state, False
        self.closures.append((i, j))
        self.corrected.append((i, j))
        self._cooldown_until = i + lc.cooldown
        self._hits.clear()
        chi2_pre, chi2_post = torch.stack([chi2_pre, _mean_obs_chi2(state)]).tolist()
        if chi2_post > chi2_pre * 1.10 + 1e-9:
            state = pre_state
            self.loop_edges.pop()
            self._record_edge(state, i, j, S, lc.near_id_edge_weight)
            self.reverted.append((i, j))
            self.corrected.pop()
        self.timings["pose_graph"] += time.perf_counter() - t0
        return state, True

    # --- correction -------------------------------------------------------------------
    def correct(self, state: SlamState, i: int, j: int, S_align, keyframes=None):
        """Pose-graph optimize over the keyframes with the new loop edge and
        every remembered one, propagate non-keyframes and map points, then
        global BA. Returns (state, applied?)."""
        F = int(state.n_frames)
        Fc = state.poses.shape[0]
        valid_np = state.pose_valid.cpu().numpy() & (np.arange(Fc) < F)
        all_valid = [f for f in range(F) if valid_np[f]]
        graph_frames = all_valid if (self.lc.graph_all_frames or keyframes is None) else keyframes
        kf = np.asarray(sorted(set(map(int, graph_frames)) | {i, j}), np.int64)
        kf = kf[valid_np[kf]]
        pos_of = {int(f): p for p, f in enumerate(kf)}
        if i not in pos_of or j not in pos_of:
            return state, False
        B = self.lc.kf_bucket
        K = len(kf)
        K_pad = Fc if self.lc.graph_all_frames else max(B, -(-K // B) * B)
        kf_pad = np.zeros(K_pad, np.int64)
        kf_pad[:K] = kf
        L = self.lc.max_loop_edges
        le_i = np.zeros(L, np.int32)
        le_j = np.zeros(L, np.int32)
        le_meas = np.tile(sim3.identity().numpy(), (L, 1, 1)).astype(np.float32)
        le_valid = np.zeros(L, bool)
        le_w = np.ones(L, np.float32)
        for n, (a, b, m, w) in enumerate(self.loop_edges[-L:]):
            if a in pos_of and b in pos_of:
                le_i[n], le_j[n] = pos_of[a], pos_of[b]
                le_meas[n] = m
                le_valid[n] = True
                le_w[n] = w
        dev = state.poses.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        new_state, ok = self._correct_impl(
            state, t(kf_pad), K, pos_of[i], pos_of[j], i, j, S_align,
            t(le_i), t(le_j), t(le_meas), t(le_valid), t(le_w),
        )
        if not bool(ok):
            return state, False
        state = new_state
        self._record_edge(state, i, j, sim3.identity(device=dev), self.lc.loop_edge_weight)
        if self.lc.run_global_ba:
            t0 = time.perf_counter()
            gba_list = keyframes if keyframes is not None else all_valid
            gba_kf = [f for f in sorted(set(map(int, gba_list)) | {i, j}) if valid_np[f]]
            gba_pad = np.zeros(Fc, np.int64)
            gba_pad[: len(gba_kf)] = gba_kf
            state = self._global_ba(state, t(gba_pad), len(gba_kf))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.timings["global_ba"] += time.perf_counter() - t0
        return state, True

    def _correct_impl(self, state: SlamState, kf_pad, K: int, pos_i: int, pos_j: int,
                      fi: int, fj: int, S_align, le_i, le_j, le_meas, le_valid, le_w):
        """Keyframe Sim3 graph (odometry + new loop edge + remembered loop
        edges), LM, non-keyframe propagation through reference keyframes,
        map points moved with their anchor frames; refuses (ok False) on any
        non-finite result. Returns (state, ok tensor)."""
        Fc = state.poses.shape[0]
        K_pad = kf_pad.shape[0]
        dev, dt = state.poses.device, state.poses.dtype
        verts = sim3.from_se3(state.poses)
        T_i_corr = sim3.compose(sim3.from_se3(state.poses[fi]), sim3.inverse(S_align))
        meas_loop = sim3.compose(T_i_corr, sim3.inverse(sim3.from_se3(state.poses[fj])))
        vert_valid = torch.arange(K_pad, device=dev) < K
        vk = verts[kf_pad]
        g = pose_graph.sequential_graph(
            vk, vert_valid,
            extra_i=torch.cat([torch.tensor([pos_i], dtype=torch.int32, device=dev), le_i]),
            extra_j=torch.cat([torch.tensor([pos_j], dtype=torch.int32, device=dev), le_j]),
            extra_meas=torch.cat([meas_loop[None], le_meas.to(dt)]),
            extra_valid=torch.cat([torch.ones(1, dtype=torch.bool, device=dev), le_valid]),
            extra_weight=torch.cat([torch.full((1,), self.lc.loop_edge_weight, dtype=dt, device=dev),
                                    le_w.to(dt)]),
        )
        g = g._replace(fixed=g.fixed | ~vert_valid)  # padding vertices alias frame 0
        if K_pad <= POSE_GRAPH_DENSE_MAX:
            res = pose_graph.optimize(g, n_iters=20, huber_delta=self.lc.pg_huber_delta)
        else:
            # the dense (7K)^2 Cholesky per LM step gives way to matrix-free
            # PCG over the same edge blocks
            res = pose_graph.optimize_cg(g, n_iters=20, max_cg_iters=POSE_GRAPH_CG_ITERS,
                                         huber_delta=self.lc.pg_huber_delta)
        ok = torch.isfinite(res.vertices).all()

        rows = torch.where(vert_valid, kf_pad, Fc)
        in_kf = mark(Fc, rows)
        kf_pos = set_last(torch.zeros(Fc, dtype=torch.long, device=dev), rows,
                          torch.arange(K_pad, device=dev))
        ref_pos = _ref_positions(in_kf, kf_pos)
        rel = sim3.compose(verts, sim3.inverse(vk[ref_pos]))
        verts_new = sim3.compose(rel, res.vertices[ref_pos])

        cam_idx, pt_idx, _, _, e_valid = state_mod.observation_edges(state)
        P = state.points.shape[0]
        big = Fc + 1
        anchor = segment_min(torch.where(e_valid, cam_idx, big).to(torch.int32), pt_idx, P)
        has_anchor = anchor < big
        anchor_safe = torch.clamp(anchor, 0, Fc - 1).long()
        X_corr = sim3.apply(sim3.inverse(verts_new[anchor_safe]),
                            sim3.apply(verts[anchor_safe], state.points))
        points = torch.where((has_anchor & state.point_valid)[:, None], X_corr, state.points)

        valid = state.pose_valid & (torch.arange(Fc, device=dev) < torch.clamp(state.n_frames, min=fi + 1))
        poses = sim3.to_se3(verts_new)
        ok = ok & torch.isfinite(points).all() & torch.isfinite(poses).all()
        poses = _orthonormal(poses)
        new_state = state._replace(
            poses=torch.where((ok & valid)[:, None, None], poses, state.poses),
            points=torch.where(ok, points, state.points),
        )
        return new_state, ok

    def _global_ba(self, state: SlamState, kf_pad, K: int) -> SlamState:
        """Global BA on the dense Schur engine, or past F*P = 4e6 (where its
        (F*6, P*3) cross terms outgrow the reference's device) on the
        matrix-free CG engine."""
        F, P = state.poses.shape[0], state.points.shape[0]
        return self._gba_impl(state, kf_pad, K, self.global_ba_solver(cg=F * P > 4_000_000))

    def global_ba_solver(self, cg: bool):
        """`solver(prob) -> BAResult` of global BA: the dense Schur LM, or
        with `cg` the matrix-free PCG LM."""
        n = self.lc.global_ba_iters
        if cg:
            return lambda pr: cg_ba.bundle_adjust_cg(pr, n_iters=n, max_cg_iters=GLOBAL_BA_CG_ITERS)
        return lambda pr: ba_mod.bundle_adjust(pr, n_iters=n)

    def _gba_impl(self, state: SlamState, kf_pad, K: int, solver) -> SlamState:
        """Keyframe-only global BA by `solver(prob) -> BAResult` (non-keyframe
        poses fixed, their observations dropped), then every non-keyframe
        re-anchored through its reference keyframe's new pose; the input
        state on any non-finite result."""
        Fc = state.poses.shape[0]
        K_pad = kf_pad.shape[0]
        dev = state.poses.device
        cam_idx, pt_idx, uv, info, valid = state_mod.observation_edges(state)
        vert_valid = torch.arange(K_pad, device=dev) < K
        rows = torch.where(vert_valid, kf_pad, Fc)
        kf_mask = mark(Fc, rows)
        prob = ba_mod.BAProblem(
            poses=state.poses, points=state.points, k=state.k, cam_idx=cam_idx,
            pt_idx=pt_idx, uv=uv, info=info, valid=valid & kf_mask[cam_idx],
            fixed=~state.pose_valid | (torch.arange(Fc, device=dev) == 0) | ~kf_mask,
        )
        res = solver(prob)
        ok = torch.isfinite(res.poses).all() & torch.isfinite(res.points).all()
        kf_pos = set_last(torch.zeros(Fc, dtype=torch.long, device=dev), rows,
                          torch.arange(K_pad, device=dev))
        ref_pos = _ref_positions(kf_mask, kf_pos)
        kf_safe = torch.where(vert_valid, kf_pad, 0)
        T_ref_old = state.poses[kf_safe][ref_pos]
        T_ref_new = res.poses[kf_safe][ref_pos]
        prop = se3_mod.compose(se3_mod.compose(state.poses, se3_mod.inverse(T_ref_old)), T_ref_new)
        keep_ba = kf_mask | ~state.pose_valid
        poses = torch.where(keep_ba[:, None, None], res.poses, prop)
        ok = ok & torch.isfinite(poses).all()
        return state._replace(poses=torch.where(ok, _orthonormal(poses), state.poses),
                              points=torch.where(ok, res.points, state.points))

    # --- legacy one-call entry --------------------------------------------------------
    def run(self, state: SlamState, i: int, key, is_keyframe: bool = True, keyframes=None):
        """DetectLoop -> ComputeSim3 -> CorrectLoop for keyframe i; returns
        (state, closed?). The session does not call this."""
        if not is_keyframe or self._slot(state, i) is None:
            return state, False
        self.timings["n_runs"] += 1
        t0 = time.perf_counter()
        q = self._bow_of(state, i)
        self.timings["bow"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        j = self.detect(i, q=q)
        self.add_frame(state, i, q=q)
        self.timings["detect"] += time.perf_counter() - t0
        if j is None:
            return state, False
        return self.close(state, i, j, key, keyframes)
