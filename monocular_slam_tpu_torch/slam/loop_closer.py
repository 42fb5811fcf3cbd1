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
quality guard. Each device stage is a program of the session the closer is
attached to (a CUDA graph on the card, captured at first use, as the
reference compiles its programs), with the reference's host reads of a few
scalars between them, at closure rate.
Keyframe graphs past `POSE_GRAPH_DENSE_MAX` vertices (512; the reference:
128) take the matrix-free `pose_graph.optimize_cg`, and global BA past F*P =
4e6 takes `cg_ba.bundle_adjust_cg`, as in the reference; they run
`POSE_GRAPH_CG_ITERS` and `GLOBAL_BA_CG_ITERS` PCG steps per LM iteration
(the reference 100 and 50).

The database row insert updates `db` in place (the reference returns a new
array); the session owns the one database tensor.
"""

from __future__ import annotations

import math
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
from monocular_slam_tpu_torch.utils import graph, prng
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




def _edge_meas(state: SlamState, i, j, S_align) -> torch.Tensor:
    """The loop constraint S_meas_ij = (T_i o S^-1) o T_j^-1 (3, 5)."""
    T_i_corr = sim3.compose(sim3.from_se3(take(state.poses, i)), sim3.inverse(S_align))
    return sim3.compose(T_i_corr, sim3.inverse(sim3.from_se3(take(state.poses, j))))


class LoopCloser:
    """Loop-closure component over a `SlamSession`'s state. The session runs
    `detect_step` per frame and calls `offer`/`close` with its outputs; the
    standalone `add_frame`/`detect`/`run` host API is kept for direct use.

    Attached to a session (`attach`, which `SlamSession` calls), the
    closure's device work runs as the session's programs over the session's
    state, with the reference's host reads between them: the Sim3 program
    (the reference's `_sim3_fn`) and one read; the near-identity gate on the
    host; one read of `n_frames` and `pose_valid`; the correction program
    of the keyframe bucket (`_correct_fns[K_pad]`), which also takes the
    chi2 before, and one read of its `ok`; the global-BA program
    (`_gba_fns`), which also takes the chi2 after, and one read. On the
    card's graph route the CG routes are a program before the solve, ONE
    LM iteration replayed `n_iters` times with its carry in static
    buffers, and a program after it; the dense routes are one program each.
    Given any other state (or unattached), the same functions run op by op
    on that state."""

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
        self.routes: list[dict] = []  # one entry per correction: routes, sizes, chi2
        self._session = None
        self._io = graph.Statics(self.device)  # static inputs and outputs of the programs
        self._sim3_host: dict = {}  # the last Sim3's host values
        self._chi2_host = (math.nan, math.nan)  # the last correction's chi2 before, after

    def attach(self, session) -> None:
        """Run the closer's device work as `session`'s programs, on its
        state and in its graph pool."""
        self._session = session

    # --- programs ---------------------------------------------------------------
    def _on_session(self, state) -> bool:
        return self._session is not None and state is self._session.state

    def _graphs_on(self, state) -> bool:
        return self._on_session(state) and self._session._use_graphs

    def _key(self, *parts) -> tuple:
        """A program key of this closer (its buffers are its own)."""
        return parts + (id(self),)

    def _run(self, key, state, fn):
        """`fn(st, commit)` on `state`: the session's program `key` when
        `state` is its session's, else one op-by-op call on `state`.
        Returns fn's outputs."""
        if self._on_session(state):
            sess = self._session
            return sess._run(self._key(*key), lambda commit: fn(sess.state, commit))
        with torch.inference_mode():
            return fn(state, True)

    def _apply(self, key, state, fn) -> SlamState:
        """A program that changes the state: `fn(st, commit)` returns the new
        state, committed to the session's state when `commit`. Returns the
        state after it."""
        if self._on_session(state):
            sess = self._session

            def run(commit):
                new = fn(sess.state, commit)
                if commit:
                    sess.state = new

            sess._run(self._key(*key), run)
            return sess.state
        with torch.inference_mode():
            return fn(state, True)

    # --- small device helpers -------------------------------------------------
    def _bow_of(self, state: SlamState, i) -> torch.Tensor:
        sl = state_mod.slot_index(state, i)
        return vocab_mod.bow_vector(self.voc, take(state.desc_pm1, sl), take(state.kp_valid, sl))

    def insert_from_state(self, state: SlamState, i: int) -> None:
        self._db[i] = self._bow_of(state, i)

    def reloc_scores(self, state: SlamState, i) -> torch.Tensor:
        """(F,) BoW scores of frame i (a host int or a 0-d device tensor)
        against inserted rows (-inf elsewhere)."""
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
    def _sim3_device(self, state: SlamState, i, j, key, u=None):
        """The Sim3 program's body: K2 matches of frames i and j whose
        features both carry map points, the reprojection-gated RANSAC and
        its polish. Returns (S (3, 5), the packed [ok, n_inliers, S, log S,
        S_meas]); ok is False, and n 0, when either frame has no slot."""
        si, sj = take(state.slot_of, i), take(state.slot_of, j)
        resident = (si >= 0) & (sj >= 0)
        sl_i, sl_j = torch.clamp(si, min=0).long(), torch.clamp(sj, min=0).long()
        a, b = take(state.desc_pm1, sl_i), take(state.desc_pm1, sl_j)
        av, bv = take(state.kp_valid, sl_i), take(state.kp_valid, sl_j)
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
        pid_i = take(state.feat_point, sl_i)
        pid_j = take(state.feat_point, sl_j)[idx]
        ok = m.ok & (pid_i >= 0) & (pid_j >= 0)
        res = alignment.ransac_sim3_reproj(
            key, state.points[torch.clamp(pid_i, min=0).long()],
            state.points[torch.clamp(pid_j, min=0).long()], ok,
            take(state.kp_uv, sl_i), take(state.kp_uv, sl_j)[idx], take(state.k, i),
            take(state.k, j), take(state.poses, i), take(state.poses, j),
            n_iters=self.lc.sim3_iters, px_thresh=self.lc.sim3_px_thresh,
            min_inliers=self.lc.sim3_min_inliers, u=u,
        )
        n = torch.where(resident, res.n_inliers, 0)
        packed = graph.pack([res.ok & resident, n],
                            [res.S, sim3.log(res.S), _edge_meas(state, i, j, res.S)])
        return res.S, packed

    def compute_sim3(self, state: SlamState, i: int, j: int, key, u=None):
        """Sim3 aligning frame i's map geometry to frame j's through K2
        descriptor matches whose features both carry map points, as one
        program and ONE host read. Returns (S (3, 5), n_inliers) or (None,
        n_inliers); S is the closer's static buffer (copy what you keep).
        `key`: the RANSAC's host key; `u`: its (sim3_iters, N) uniforms in
        place of `key` (op by op only)."""
        key_words = prng.split(prng.PRNGKey(0))[0] if key is None else key
        words = self._io.words("sim3_in", 4).fill([i, j], np.asarray(key_words, np.uint32))
        out = self._io.readback("sim3_out", 2 + 15 + 7 + 15)
        S_buf = self._io.buffer("S", sim3.identity(device=self.device))

        def fn(st, commit):
            S, packed = self._sim3_device(st, words[0], words[1], words[2:4] if u is None else None,
                                          u)
            if commit:
                S_buf.copy_(S)
                out.dev.copy_(packed)

        if u is not None and self._graphs_on(state):
            raise ValueError("compute_sim3: uniforms `u` are taken op by op only")
        self._run(("sim3",), state, fn)
        vals = out.start().get()
        f = vals[2:].view(np.float32)
        self._sim3_host = {"xi": f[15:22].copy(), "meas": f[22:37].reshape(3, 5).copy()}
        ok, n = bool(vals[0]), int(vals[1])
        return (S_buf if ok else None), n

    # --- loop-edge memory ---------------------------------------------------------
    def _remember(self, i: int, j: int, meas: np.ndarray, weight: float) -> None:
        self.loop_edges.append((i, j, np.asarray(meas, np.float32), weight))
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
        xi, meas = self._sim3_host["xi"], self._sim3_host["meas"]
        if (float(np.linalg.norm(xi[3:6])) < lc.id_rot_rad
                and float(np.linalg.norm(xi[0:3])) < lc.id_trans
                and abs(float(xi[6])) < lc.id_log_scale):
            self._remember(i, j, meas, lc.near_id_edge_weight)
            self.closures.append((i, j))
            self.skipped_identity.append((i, j))
            self._cooldown_until = i + lc.cooldown
            self._hits.clear()
            return state, True
        t0 = time.perf_counter()
        pre_state = state
        state, applied = self.correct(state, i, j, S, keyframes=keyframes)
        if not applied:
            self.timings["pose_graph"] += time.perf_counter() - t0
            return state, False
        self.closures.append((i, j))
        self.corrected.append((i, j))
        self._cooldown_until = i + lc.cooldown
        self._hits.clear()
        chi2_pre, chi2_post = self._chi2_host
        if chi2_post > chi2_pre * 1.10 + 1e-9:
            state = self._restore(pre_state, state)
            self.loop_edges.pop()
            self._remember(i, j, meas, lc.near_id_edge_weight)
            self.reverted.append((i, j))
            self.corrected.pop()
        self.timings["pose_graph"] += time.perf_counter() - t0
        return state, True

    def _restore(self, pre_state: SlamState, state: SlamState) -> SlamState:
        """The state before the correction: the session's from the poses
        and points the correction program kept, a given state as it was."""
        if not self._on_session(state):
            return pre_state
        poses, points = self._io["backup_poses"], self._io["backup_points"]
        return self._apply(("restore",), state,
                           lambda st, commit: st._replace(poses=poses.clone(),
                                                          points=points.clone()))

    # --- correction -------------------------------------------------------------------
    def _valid_frames(self, state: SlamState):
        """(n_frames, pose_valid & frame < n_frames) on the host: one read."""
        Fc = state.poses.shape[0]
        out = self._io.readback("valid_out", 1 + Fc)

        def fn(st, commit):
            if commit:
                out.dev.copy_(graph.pack([st.n_frames, st.pose_valid]))

        self._run(("valid",), state, fn)
        vals = out.start().get()
        F = int(vals[0])
        return F, (vals[1:] != 0) & (np.arange(Fc) < F)

    def correct(self, state: SlamState, i: int, j: int, S_align, keyframes=None):
        """Pose-graph optimize over the keyframes with the new loop edge and
        every remembered one, propagate non-keyframes and map points, then
        global BA. Returns (state, applied?); the chi2 before and after are
        kept for `close`'s guard."""
        F, valid_np = self._valid_frames(state)
        Fc = state.poses.shape[0]
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
        le_i = np.zeros(L, np.int64)
        le_j = np.zeros(L, np.int64)
        le_meas = np.tile(sim3.identity().numpy(), (L, 1, 1)).astype(np.float32)
        le_valid = np.zeros(L, np.int64)
        le_w = np.ones(L, np.float32)
        for n, (a, b, m, w) in enumerate(self.loop_edges[-L:]):
            if a in pos_of and b in pos_of:
                le_i[n], le_j[n] = pos_of[a], pos_of[b]
                le_meas[n] = m
                le_valid[n] = 1
                le_w[n] = w
        S_in = self._io.buffer("S", sim3.identity(device=self.device))
        if S_align is not S_in:
            S_in.copy_(S_align)
        words = self._io.words(("correct_in", K_pad), 5 + K_pad + 19 * L).fill(
            [K, pos_of[i], pos_of[j], i, j], kf_pad, le_i, le_j, le_valid, le_meas, le_w)
        cg = K_pad > POSE_GRAPH_DENSE_MAX
        route = {"frame": i, "K": K, "K_pad": K_pad, "pose_graph": "cg" if cg else "dense"}
        state, vals = self._correct_run(state, words, K_pad, cg)
        f = vals[2:].view(np.float32)
        route.update(pg_chi2=[float(f[16]), float(f[17])], pg_iters=int(vals[1]))
        if not vals[0]:
            self.routes.append(route)
            return state, False
        chi2_pre = float(f[0])
        self._remember(i, j, f[1:16].reshape(3, 5).copy(), self.lc.loop_edge_weight)
        t0 = time.perf_counter()
        if self.lc.run_global_ba:
            gba_list = keyframes if keyframes is not None else all_valid
            gba_kf = [f for f in sorted(set(map(int, gba_list)) | {i, j}) if valid_np[f]]
            gba_pad = np.zeros(Fc, np.int64)
            gba_pad[: len(gba_kf)] = gba_kf
            state = self._global_ba(state, gba_pad, len(gba_kf))
            g = self._gba_host
            route.update(global_ba=g["route"], gba_chi2=g["chi2"], gba_iters=g["iters"])
            chi2_post = g["chi2_after"]
            self.timings["global_ba"] += time.perf_counter() - t0
        else:
            chi2_post = self._mean_chi2(state)
        self._chi2_host = (chi2_pre, chi2_post)
        self.routes.append(route)
        return state, True

    def _mean_chi2(self, state: SlamState) -> float:
        """`_mean_obs_chi2` of the state on the host (the reference's
        `_obs_chi2`): a program and one read."""
        out = self._io.readback("chi2_out", 1)

        def fn(st, commit):
            c = _mean_obs_chi2(st)
            if commit:
                out.dev.copy_(graph.pack(fl=[c]))

        self._run(("chi2",), state, fn)
        return float(out.start().get().view(np.float32)[0])

    def _correct_inputs(self, w: torch.Tensor, K_pad: int):
        """The correction's device inputs from its control words."""
        L = self.lc.max_loop_edges
        K, pos_i, pos_j, fi, fj = w[0], w[1], w[2], w[3], w[4]
        o = 5 + K_pad
        kf_pad = w[5:o]
        le_i, le_j = w[o:o + L].to(torch.int32), w[o + L:o + 2 * L].to(torch.int32)
        le_valid = w[o + 2 * L:o + 3 * L] != 0
        le_meas = graph.floats(w[o + 3 * L:o + 18 * L]).reshape(L, 3, 5)
        le_w = graph.floats(w[o + 18 * L:o + 19 * L])
        return kf_pad, K, pos_i, pos_j, fi, fj, le_i, le_j, le_meas, le_valid, le_w

    def _correct_run(self, state: SlamState, words: torch.Tensor, K_pad: int, cg: bool):
        """The correction of one keyframe bucket: the correction programs
        (their state committed), then ONE read of [ok, LM iterations, chi2
        before, S_meas of the corrected loop, the graph's chi2 before and
        after]. Returns (state, host int32 values)."""
        out = self._io.readback("correct_out", 2 + 18)
        S_in = self._io["S"]
        lc = self.lc
        bk_poses = self._io.buffer("backup_poses", state.poses)
        bk_points = self._io.buffer("backup_points", state.points)

        def begin(st, commit):
            if commit:
                bk_poses.copy_(st.poses)
                bk_points.copy_(st.points)
            return _mean_obs_chi2(st)

        def end(st, new, ok, chi2_pre, pg, n_run, commit):
            fi, fj = words[3], words[4]
            meas = _edge_meas(new, fi, fj, sim3.identity(device=new.poses.device))
            if commit:
                out.dev.copy_(graph.pack([ok, n_run], [chi2_pre, meas, pg[0], pg[1]]))
            return new

        sess = self._session
        if self._graphs_on(state) and cg:
            sess._graphs.drop(lambda k: k[0] == "correct" and k[1] < K_pad)

            def pre(commit):
                st = sess.state
                chi2_pre = begin(st, commit)
                args = self._correct_inputs(words, K_pad)
                g, aux = self._correct_graph(st, *args[:6], S_in, *args[6:])
                carry, chi2_0 = pose_graph.optimize_cg_start(g, huber_delta=lc.pg_huber_delta)
                return g, aux, graph.cloned(carry), chi2_0, chi2_pre

            g, aux, carry, chi2_0, chi2_pre = sess._run(self._key("correct", K_pad, "cg", "pre"),
                                                        pre)
            leaves = graph.leaves(carry)

            def step(commit):
                new = pose_graph.optimize_cg_step(g, carry, max_cg_iters=POSE_GRAPH_CG_ITERS,
                                                  huber_delta=lc.pg_huber_delta)
                if commit:
                    graph.copy_leaves(leaves, new)

            for _ in range(20):
                sess._run(self._key("correct", K_pad, "cg", "step"), step)

            def post(commit):
                st = sess.state
                kf_pad, K, fi = words[5:5 + K_pad], words[0], words[3]
                new, ok = self._correct_finish(st, kf_pad, K, fi, aux, carry.verts)
                end(st, new, ok, chi2_pre, (chi2_0, carry.st.chi2), carry.n_run, commit)
                if commit:
                    sess.state = new

            sess._run(self._key("correct", K_pad, "cg", "post"), post)
            state = sess.state
        else:
            if self._graphs_on(state):
                sess._graphs.drop(lambda k: k[0] == "correct" and k[1] < K_pad)

            def fn(st, commit):
                chi2_pre = begin(st, commit)
                args = self._correct_inputs(words, K_pad)
                new, ok, res = self._correct_impl(st, *args[:6], S_in, *args[6:], with_result=True)
                return end(st, new, ok, chi2_pre, (res.chi2_initial, res.chi2_history[-1]),
                           res.n_iters_run, commit)

            state = self._apply(("correct", K_pad, "cg" if cg else "dense"), state, fn)
        return state, out.start().get()

    def _correct_graph(self, state: SlamState, kf_pad, K, pos_i, pos_j, fi, fj, S_align, le_i,
                       le_j, le_meas, le_valid, le_w):
        """The keyframe Sim3 graph: odometry edges, the new loop edge and the
        remembered ones; padding vertices alias frame 0 and stay fixed.
        Returns (graph, (verts, vk, vert_valid))."""
        K_pad = kf_pad.shape[0]
        dev, dt = state.poses.device, state.poses.dtype
        verts = sim3.from_se3(state.poses)
        meas_loop = _edge_meas(state, fi, fj, S_align)
        vert_valid = torch.arange(K_pad, device=dev) < K
        vk = verts[kf_pad.long()]
        g = pose_graph.sequential_graph(
            vk, vert_valid,
            extra_i=torch.cat([index1(pos_i, dev).to(torch.int32), le_i]),
            extra_j=torch.cat([index1(pos_j, dev).to(torch.int32), le_j]),
            extra_meas=torch.cat([meas_loop[None], le_meas.to(dt)]),
            extra_valid=torch.cat([torch.ones(1, dtype=torch.bool, device=dev), le_valid]),
            extra_weight=torch.cat([torch.full((1,), self.lc.loop_edge_weight, dtype=dt, device=dev),
                                    le_w.to(dt)]),
        )
        g = g._replace(fixed=g.fixed | ~vert_valid)
        return g, (verts, vk, vert_valid)

    def _correct_finish(self, state: SlamState, kf_pad, K, fi, aux, vertices):
        """Non-keyframes through their reference keyframes, map points with
        their anchor frames; refuses (ok False) on any non-finite result.
        Returns (state, ok tensor)."""
        verts, vk, vert_valid = aux
        Fc = state.poses.shape[0]
        K_pad = kf_pad.shape[0]
        dev = state.poses.device
        ok = torch.isfinite(vertices).all()
        rows = torch.where(vert_valid, kf_pad.long(), Fc)
        in_kf = mark(Fc, rows)
        kf_pos = set_last(torch.zeros(Fc, dtype=torch.long, device=dev), rows,
                          torch.arange(K_pad, device=dev))
        ref_pos = _ref_positions(in_kf, kf_pos)
        rel = sim3.compose(verts, sim3.inverse(vk[ref_pos]))
        verts_new = sim3.compose(rel, vertices[ref_pos])

        cam_idx, pt_idx, _, _, e_valid = state_mod.observation_edges(state)
        P = state.points.shape[0]
        big = Fc + 1
        anchor = segment_min(torch.where(e_valid, cam_idx, big).to(torch.int32), pt_idx, P)
        has_anchor = anchor < big
        anchor_safe = torch.clamp(anchor, 0, Fc - 1).long()
        X_corr = sim3.apply(sim3.inverse(verts_new[anchor_safe]),
                            sim3.apply(verts[anchor_safe], state.points))
        points = torch.where((has_anchor & state.point_valid)[:, None], X_corr, state.points)

        n_hi = torch.maximum(state.n_frames.long(), index1(fi, dev)[0] + 1)
        valid = state.pose_valid & (torch.arange(Fc, device=dev) < n_hi)
        poses = sim3.to_se3(verts_new)
        ok = ok & torch.isfinite(points).all() & torch.isfinite(poses).all()
        poses = _orthonormal(poses)
        new_state = state._replace(
            poses=torch.where((ok & valid)[:, None, None], poses, state.poses),
            points=torch.where(ok, points, state.points),
        )
        return new_state, ok

    def _correct_impl(self, state: SlamState, kf_pad, K, pos_i, pos_j, fi, fj, S_align, le_i,
                      le_j, le_meas, le_valid, le_w, with_result: bool = False):
        """Keyframe Sim3 graph (odometry + new loop edge + remembered loop
        edges), LM, non-keyframe propagation through reference keyframes,
        map points moved with their anchor frames; refuses (ok False) on any
        non-finite result. The ids and counts are host ints or 0-d device
        tensors. Returns (state, ok tensor), and the graph's result with
        `with_result`."""
        g, aux = self._correct_graph(state, kf_pad, K, pos_i, pos_j, fi, fj, S_align, le_i, le_j,
                                     le_meas, le_valid, le_w)
        if kf_pad.shape[0] <= POSE_GRAPH_DENSE_MAX:
            res = pose_graph.optimize(g, n_iters=20, huber_delta=self.lc.pg_huber_delta)
        else:
            # the dense (7K)^2 Cholesky per LM step gives way to matrix-free
            # PCG over the same edge blocks
            res = pose_graph.optimize_cg(g, n_iters=20, max_cg_iters=POSE_GRAPH_CG_ITERS,
                                         huber_delta=self.lc.pg_huber_delta)
        new_state, ok = self._correct_finish(state, kf_pad, K, fi, aux, res.vertices)
        return (new_state, ok, res) if with_result else (new_state, ok)

    # --- global BA ----------------------------------------------------------------------
    def _global_ba(self, state: SlamState, kf_pad, K: int) -> SlamState:
        """Global BA over the keyframes `kf_pad[:K]` ((Fc,) host array or
        tensor) on the dense Schur engine, or past F*P = 4e6 (where its
        (F*6, P*3) cross terms outgrow the reference's device) on the
        matrix-free CG engine; the reference's `_gba_fns`, with the chi2
        after it (`_obs_chi2`) and ONE read."""
        F, P = state.poses.shape[0], state.points.shape[0]
        cg = F * P > 4_000_000
        pad = kf_pad.cpu().numpy() if torch.is_tensor(kf_pad) else np.asarray(kf_pad)
        words = self._io.words("gba_in", 1 + F).fill([K], pad.astype(np.int64))
        out = self._io.readback("gba_out", 1 + 3)

        def end(new, res_chi2, n_it, commit):
            if commit:
                out.dev.copy_(graph.pack([n_it], [_mean_obs_chi2(new), res_chi2[0], res_chi2[1]]))
            return new

        sess = self._session
        if self._graphs_on(state) and cg:
            n, steps = self.lc.global_ba_iters, GLOBAL_BA_CG_ITERS

            def pre(commit):
                prob, aux = self._gba_problem(sess.state, words[1:], words[0])
                carry = ba_mod.bundle_adjust_start(prob)
                return prob, aux, graph.cloned(carry), carry.lin["chi2"]

            prob, aux, carry, chi2_0 = sess._run(self._key("gba", "cg", "pre"), pre)
            leaves = graph.leaves(carry)

            def step(commit):
                new = cg_ba.bundle_adjust_cg_step(prob, carry, max_cg_iters=steps)
                if commit:
                    graph.copy_leaves(leaves, new)

            for _ in range(n):
                sess._run(self._key("gba", "cg", "step"), step)

            def post(commit):
                st = sess.state
                new = self._gba_finish(st, words[1:], words[0], aux, carry.poses, carry.points)
                end(new, (chi2_0, carry.st.chi2), carry.st.it, commit)
                if commit:
                    sess.state = new

            sess._run(self._key("gba", "cg", "post"), post)
            state = sess.state
        else:
            def fn(st, commit):
                new, res = self._gba_impl(st, words[1:], words[0], self.global_ba_solver(cg=cg),
                                          with_result=True)
                return end(new, (res.chi2_initial, res.chi2_history[-1]), res.n_iters_run, commit)

            state = self._apply(("gba", "cg" if cg else "dense"), state, fn)
        vals = out.start().get()
        f = vals[1:].view(np.float32)
        self._gba_host = {"route": "cg" if cg else "dense", "iters": int(vals[0]),
                          "chi2_after": float(f[0]), "chi2": [float(f[1]), float(f[2])]}
        return state

    def global_ba_solver(self, cg: bool):
        """`solver(prob) -> BAResult` of global BA: the dense Schur LM, or
        with `cg` the matrix-free PCG LM."""
        n = self.lc.global_ba_iters
        if cg:
            return lambda pr: cg_ba.bundle_adjust_cg(pr, n_iters=n, max_cg_iters=GLOBAL_BA_CG_ITERS)
        return lambda pr: ba_mod.bundle_adjust(pr, n_iters=n)

    def _gba_problem(self, state: SlamState, kf_pad, K):
        """The keyframe-only BA problem (non-keyframe poses fixed, their
        observations dropped) and (rows, kf_mask, vert_valid)."""
        Fc = state.poses.shape[0]
        K_pad = kf_pad.shape[0]
        dev = state.poses.device
        kf_pad = kf_pad.long()
        cam_idx, pt_idx, uv, info, valid = state_mod.observation_edges(state)
        vert_valid = torch.arange(K_pad, device=dev) < K
        rows = torch.where(vert_valid, kf_pad, Fc)
        kf_mask = mark(Fc, rows)
        prob = ba_mod.BAProblem(
            poses=state.poses, points=state.points, k=state.k, cam_idx=cam_idx,
            pt_idx=pt_idx, uv=uv, info=info, valid=valid & kf_mask[cam_idx],
            fixed=~state.pose_valid | (torch.arange(Fc, device=dev) == 0) | ~kf_mask,
        )
        return prob, (rows, kf_mask, vert_valid)

    def _gba_finish(self, state: SlamState, kf_pad, K, aux, poses_ba, points_ba) -> SlamState:
        """Every non-keyframe re-anchored through its reference keyframe's
        new pose; the input state on any non-finite result."""
        rows, kf_mask, vert_valid = aux
        Fc = state.poses.shape[0]
        K_pad = kf_pad.shape[0]
        dev = state.poses.device
        kf_pad = kf_pad.long()
        ok = torch.isfinite(poses_ba).all() & torch.isfinite(points_ba).all()
        kf_pos = set_last(torch.zeros(Fc, dtype=torch.long, device=dev), rows,
                          torch.arange(K_pad, device=dev))
        ref_pos = _ref_positions(kf_mask, kf_pos)
        kf_safe = torch.where(vert_valid, kf_pad, 0)
        T_ref_old = state.poses[kf_safe][ref_pos]
        T_ref_new = poses_ba[kf_safe][ref_pos]
        prop = se3_mod.compose(se3_mod.compose(state.poses, se3_mod.inverse(T_ref_old)), T_ref_new)
        keep_ba = kf_mask | ~state.pose_valid
        poses = torch.where(keep_ba[:, None, None], poses_ba, prop)
        ok = ok & torch.isfinite(poses).all()
        return state._replace(poses=torch.where(ok, _orthonormal(poses), state.poses),
                              points=torch.where(ok, points_ba, state.points))

    def _gba_impl(self, state: SlamState, kf_pad, K, solver, with_result: bool = False):
        """Keyframe-only global BA by `solver(prob) -> BAResult`, then every
        non-keyframe re-anchored through its reference keyframe's new pose;
        the input state on any non-finite result. `K` is a host int or a 0-d
        device tensor. Returns the state, and the solver's result with
        `with_result`."""
        prob, aux = self._gba_problem(state, kf_pad, K)
        res = solver(prob)
        new = self._gba_finish(state, kf_pad, K, aux, res.poses, res.points)
        return (new, res) if with_result else new

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
