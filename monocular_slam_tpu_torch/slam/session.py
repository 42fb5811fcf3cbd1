"""SlamSession — the host loop over the SLAM stages (counterpart of the
image and feature paths and the loop-closer half of
`monocular_slam_tpu/slam/session.py`).

Frame 0 is the reference; later frames bootstrap against it until the
two-view map is accepted; every frame after that runs one step: ORB
extraction (the K1 kernel on a card) -> undistortion -> state ingest ->
`tracker.track` -> the keyframe rule -> the mapping block -> with a loop
closer attached, `loop_closer.detect_step`. The mapping block runs, as in
the reference, either at keyframe rate plus the cadence floor and warmup
(fuse -> windowed local BA -> cull; `BAConfig.keyframe_only`, the default)
or on every tracked frame (local BA, then fuse every `fuse_every` and cull
every `cull_every` frames).

The reference compiles the step into one program with `lax.cond` around the
mapping block. Here the step runs eagerly and pulls ONE packed vector per
frame to the host (tracked, keyframe, mapping flag, inlier and new-point
counts), then decides the mapping block with a Python `if`. Inside, the LM
loops are branch-free. Linear-algebra calls that check their status on the
host (`eigh`, `svd`) add syncs of their own; `chip_smoke.py` counts them.

With a loop closer, per-frame outcomes are acted on `stat_lag` frames late,
as in the reference: the consistency check and closures, relocalization
after `reloc_after` failures, and FrameCulling every `kf_cull_every`
keyframes (dispatched on the state of its frame, applied `stat_lag` frames
later). So closures, relocalizations and culls fire on the same frames as
in the reference.

`prewarm` pays the step's one-time costs (kernel builds, the first
extraction, functorch's first-use imports) before frame 0;
`add_frame_from_buffer` takes frames from a buffer already on the device.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from monocular_slam_tpu_torch.geometry import alignment, sim3
from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.ops import fast_score, hamming, orb
from monocular_slam_tpu_torch.ops import features as features_mod
from monocular_slam_tpu_torch.optim import pose_graph
from monocular_slam_tpu_torch.slam import keyframes as kf_mod
from monocular_slam_tpu_torch.slam import local_ba, mapping, tracker
from monocular_slam_tpu_torch.slam import loop_closer as lc_mod
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.config import SlamConfig
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils.device import resolve_device


class FrameStats:
    """Per-frame outcomes. Host fields are plain values; the mapping
    block's chi2 and fuse/cull counts stay device scalars until read, and
    the four detection outputs (`cand_j`, `cand_score`, `cand_floor`,
    `cand_n`) one packed device vector, pulled once on first read."""

    _DEVICE = ("chi2_before", "chi2_after", "n_fused", "n_culled")
    _DETECT = ("cand_j", "cand_score", "cand_floor", "cand_n")

    def __init__(self, frame: int, **kw):
        self.frame = frame
        self.tracked = False
        self.n_inliers = 0
        self.n_new_points = 0
        self.is_keyframe = False
        self.last_kf = -1
        self.loop_closed = False
        self._dev = {"chi2_before": math.nan, "chi2_after": math.nan,
                     "n_fused": 0, "n_culled": 0}
        self._det = None
        self._det_vals = {"cand_j": -1, "cand_score": 0.0, "cand_floor": 0.0, "cand_n": 0}
        for n, v in kw.items():
            setattr(self, n, v)

    def _set_detect(self, det: lc_mod.DetectOut) -> None:
        self._det = torch.stack([x.to(torch.float64) for x in det])

    def _resolve(self) -> None:
        if self._det is not None:
            j, score, floor, n = self._det.tolist()
            self._det_vals.update(cand_j=int(j), cand_score=score, cand_floor=floor, cand_n=int(n))
            self._det = None

    def __getattr__(self, name):
        d = self.__dict__
        dev = d.get("_dev")
        if dev is not None and name in dev:
            v = dev[name]
            if torch.is_tensor(v):
                v = v.item()
                dev[name] = v
            return v
        if name in FrameStats._DETECT and "_det_vals" in d:
            self._resolve()
            return d["_det_vals"][name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in FrameStats._DEVICE:
            self._dev[name] = value
        elif name in FrameStats._DETECT:
            self._resolve()
            self._det_vals[name] = value
        else:
            object.__setattr__(self, name, value)

    def __repr__(self):
        host = {n: v for n, v in self.__dict__.items() if not n.startswith("_")}
        host.update({n: getattr(self, n) for n in FrameStats._DEVICE + FrameStats._DETECT})
        return f"FrameStats({host})"


class SlamSession:
    """Feed frames (images or precomputed features), get trajectory + map.

        sess = SlamSession(cfg, seed=1)            # on the card
        for img, ts in frames:
            sess.add_frame(img, k=K, timestamp=ts)
        poses, valid, stamps = sess.trajectory()

    With loop closing: `SlamSession(cfg, loop_closer=LoopCloser(
    vocabulary.load_default(), cfg))`. `device` defaults to the card and
    raises without one; pass `device="cpu"` to run on the CPU.
    """

    def __init__(self, cfg: SlamConfig = SlamConfig(), seed: int = 0,
                 run_ba: bool = True, loop_closer: lc_mod.LoopCloser | None = None,
                 device=None):
        self.cfg = cfg
        self.run_ba = run_ba
        self.device = resolve_device(device)
        if loop_closer is not None and loop_closer.device != self.device:
            raise ValueError(f"loop closer on {loop_closer.device}, session on {self.device}")
        self.loop_closer = loop_closer
        self.state: SlamState = state_mod.empty_state(cfg, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.stats: list[FrameStats] = []
        self.timestamps: list[float] = []
        self._next = 0
        self._initialized = False
        self._init_ref = 0
        self._last_kf = -1
        self._keyframes: list[int] = []  # folded from stats (lagging with a closer)
        self._kf_scanned = 0
        self._kf_culled: set[int] = set()
        self._kf_since_cull = 0
        self._cull_pending = None  # (device flags, keyframes, dispatch frame)
        self._fail_streak = 0
        self.reloc_attempts = 0  # relocalize calls (candidates tried)
        self.reloc_successes = 0

        self._auto_steer = cfg.frontend.steer_mode == "auto"
        self._steer = "binned" if self._auto_steer else cfg.frontend.steer_mode
        self._steer_since = 0
        self._inlier_ema: float | None = None
        self._pending: list[FrameStats] = []

        S = state_mod.n_slots(cfg)
        self._slot_frame: list[int] = [-1] * S
        self._free_slots: list[int] = list(range(S - 1, -1, -1))
        self._protect_window = cfg.track.back_traverse + 2

    # --- steering health (auto mode) -------------------------------------
    def _update_steer_health(self, st: FrameStats) -> None:
        """Binned steering while tracking is healthy, continuous when the
        inlier EMA drops sharply or below auto_low, with dwell times (the
        reference's hysteresis, verbatim)."""
        fe = self.cfg.frontend
        i = st.frame
        if st.tracked:
            n = float(st.n_inliers)
            self._inlier_ema = n if self._inlier_ema is None else 0.7 * self._inlier_ema + 0.3 * n
        low = fe.auto_low * fe.n_features
        high = fe.auto_high * fe.n_features
        dwell = i - self._steer_since
        if self._steer == "binned":
            sharp_drop = (
                st.tracked and self._inlier_ema is not None
                and float(st.n_inliers) < 0.45 * self._inlier_ema
            )
            ema_low = self._inlier_ema is not None and self._inlier_ema < low
            if (not st.tracked) or (dwell >= 10 and (sharp_drop or ema_low)):
                self._steer = "continuous"
                self._steer_since = i
                self._inlier_ema = None
        elif (st.tracked and dwell >= 50 and self._inlier_ema is not None
              and self._inlier_ema > high):
            self._steer = "binned"
            self._steer_since = i

    # --- feature-slot allocator ----------------------------------------------
    def _acquire_slot(self, i: int) -> tuple[int, int]:
        """Free slot for frame i; when none is free, evict the oldest
        non-keyframe outside the protected window, then the oldest keyframe.
        Returns (slot, evicted frame or -1)."""
        if self._free_slots:
            slot = self._free_slots.pop()
            self._slot_frame[slot] = i
            return slot, -1
        protect_after = i - self._protect_window
        # with a closer the flags lag by `stat_lag` frames; lagging keyframes
        # are inside the protected window anyway
        kfs = set(self._keyframes_known() if self.loop_closer is not None else self.keyframes)
        resident = sorted((f, s) for s, f in enumerate(self._slot_frame) if f >= 0)
        victim = None
        for f, s in resident:
            if f >= protect_after:
                break
            if f not in kfs:
                victim = s
                break
        if victim is None:
            for f, s in resident:
                if f >= protect_after:
                    break
                victim = s
                break
        if victim is None:
            raise ValueError("all feature slots are held by the active window; raise cfg.max_slots")
        prev = self._slot_frame[victim]
        self._slot_frame[victim] = i
        return victim, prev

    def _release_slot(self, slot: int, prev_frame: int) -> None:
        self._slot_frame[slot] = prev_frame
        if prev_frame < 0:
            self._free_slots.append(slot)

    # --- ingest ------------------------------------------------------------------
    def _k(self, k) -> torch.Tensor:
        return torch.as_tensor(np.asarray(k, np.float32) if not torch.is_tensor(k) else k,
                               dtype=torch.float32, device=self.device)

    def _extract(self, img: torch.Tensor) -> orb.Features:
        fe = self.cfg.frontend
        return features_mod.extract(
            img, n_features=fe.n_features, n_levels=fe.n_levels,
            fast_threshold=fe.fast_threshold, steer_mode=self._steer,
        )

    def add_frame(self, img, k, timestamp: float = 0.0, dist=None) -> FrameStats:
        """Ingest a grayscale (H, W) image in [0, 255] (numpy or tensor)."""
        img = torch.as_tensor(img, device=self.device).to(torch.float32)
        with torch.inference_mode():
            feats = self._extract(img)
            if self._initialized and self._next >= 2:
                # the reference's fused image step undistorts unconditionally
                d = torch.zeros(5, device=self.device) if dist is None else self._k(dist)
                feats = feats._replace(uv=cam.undistort_pixels(self._k(k), d, feats.uv))
                return self._ingest(feats, k, timestamp)
            return self.add_frame_features(feats, k, timestamp, dist=dist)

    def add_frame_from_buffer(self, buffer: torch.Tensor, idx: int, k, timestamp: float = 0.0,
                              dist=None) -> FrameStats:
        """Ingest frame `idx` of an (N, H, W) uint8 or float32 image buffer
        that already lies on the session's device: the frame is sliced and
        converted there, with no host-to-device copy of the image."""
        if buffer.device.type != self.device.type or buffer.dim() != 3:
            raise ValueError(f"add_frame_from_buffer takes an (N, H, W) buffer on {self.device}, "
                             f"got {tuple(buffer.shape)} on {buffer.device}")
        return self.add_frame(buffer[idx], k, timestamp, dist=dist)

    def prewarm(self, image: bool = False, n_threads: int = 4) -> float:
        """Pay the step's one-time costs before frame 0 and return the
        seconds spent: on a card, K1 and K2 are built and loaded (one nvcc
        each, in parallel; a failed build raises); with `image`, one
        extraction of a zero image of `cfg.image_wh` in each steering mode
        the session can use; with a loop closer, the pose graph's edge
        Jacobians and the Sim3 RANSAC polish on tiny inputs, whose first
        `torch.func` transforms import most of functorch. The session's
        state, generator and counters are left as they were (the kernels'
        launch counters count the warm-up extraction)."""
        t0 = time.perf_counter()
        dev = self.device
        if dev.type == "cuda":
            with ThreadPoolExecutor(n_threads) as ex:
                for f in [ex.submit(fast_score.load), ex.submit(hamming.load)]:
                    f.result()
        with torch.inference_mode():
            if image:
                W, H = self.cfg.image_wh
                zero = torch.zeros((H, W), dtype=torch.float32, device=dev)
                fe = self.cfg.frontend
                for mode in (("binned", "continuous") if self._auto_steer else (self._steer,)):
                    features_mod.extract(zero, n_features=fe.n_features, n_levels=fe.n_levels,
                                         fast_threshold=fe.fast_threshold, steer_mode=mode)
            if self.loop_closer is not None:
                S = sim3.identity(device=dev)[None].expand(2, 3, 5)
                pose_graph.edge_jacobians(S, S, S)
                g = torch.Generator().manual_seed(0)
                Y = torch.rand((8, 3), generator=g).to(dev) + torch.tensor([0.0, 0.0, 4.0], device=dev)
                T = torch.eye(4, device=dev)[:3]
                k = torch.tensor([100.0, 100.0, 50.0, 50.0], device=dev)
                uv = cam.project(k, Y)
                alignment.ransac_sim3_reproj(None, Y, Y, torch.ones(8, dtype=torch.bool, device=dev),
                                             uv, uv, k, k, T, T, n_iters=2,
                                             u=torch.rand((2, 8), generator=g).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def add_frame_features(self, feats: orb.Features, k, timestamp: float,
                           dist=None) -> FrameStats:
        """Ingest precomputed features; `dist` (radtan 5-vector) undistorts
        the keypoints first when nonzero."""
        with torch.inference_mode():
            if dist is not None and np.any(np.asarray(dist) != 0):
                feats = feats._replace(uv=cam.undistort_pixels(self._k(k), self._k(dist), feats.uv))
            return self._ingest(feats, k, timestamp)

    def _ingest(self, feats: orb.Features, k, timestamp: float) -> FrameStats:
        i = self._next
        if i >= self.cfg.max_frames:
            raise ValueError(f"frame capacity {self.cfg.max_frames} exhausted")
        slot, prev = self._acquire_slot(i)
        try:
            self.state = state_mod.add_frame_features(
                self.state, i, slot, feats.uv, feats.scale, feats.valid,
                feats.desc, feats.desc_pm1, self._k(k),
            )
        except Exception:
            self._release_slot(slot, prev)
            raise
        self._next += 1
        self.timestamps.append(float(timestamp))
        st = FrameStats(frame=i)
        if i == 0:
            st.tracked = True
        elif not self._initialized:
            res = tracker.bootstrap(self.state, self.gen, self.cfg, self._init_ref, i)
            self.state = res.state
            ok, n_inl, n_pts = torch.stack([res.ok.long(), res.n_inliers.long(),
                                            res.n_points.long()]).tolist()
            st.tracked = bool(ok)
            st.n_inliers = n_inl
            st.n_new_points = n_pts
            if st.tracked:
                self._initialized = True
                st.is_keyframe = True
                self._last_kf = i
                if self.loop_closer is not None:
                    # the map's first anchor must be queryable for closure
                    self.loop_closer.insert_from_state(self.state, i)
            elif i - self._init_ref >= self.cfg.init.max_defer:
                self._init_ref = i - 1
        else:
            self._step(i, st)
        st.last_kf = self._last_kf
        self._enqueue(st)
        return st

    def _step(self, i: int, st: FrameStats) -> None:
        """Track frame i, apply the keyframe rule and, when due, the mapping
        block. One host pull per frame."""
        cfg = self.cfg
        m = cfg.mapping
        tres = tracker.track(self.state, i, self.gen, cfg)
        self.state = tres.state
        last_kf = self._last_kf
        kf0 = max(last_kf, 0)
        kf_resident = self.state.slot_of[kf0] >= 0
        ov = torch.where(kf_resident, mapping.frame_overlap(self.state, i, kf0), 0.0)
        is_kf = tres.ok & ((last_kf < 0) | (ov < m.keyframe_overlap)
                           | (i - last_kf >= m.keyframe_max_gap))
        run_map = is_kf if cfg.ba.keyframe_only else tres.ok
        if cfg.ba.keyframe_only and cfg.ba.cadence_floor:
            run_map = run_map | (tres.ok & (i % cfg.ba.cadence_floor == 0))
        if cfg.ba.keyframe_only and cfg.ba.warmup_frames:
            run_map = run_map | (tres.ok & (i < cfg.ba.warmup_frames))
        ok, is_kf, run_map, n_inl, n_new = torch.stack([
            tres.ok.long(), is_kf.long(), run_map.long(),
            tres.n_pnp_inliers.long(), tres.n_new_points.long(),
        ]).tolist()
        st.tracked, st.is_keyframe = bool(ok), bool(is_kf)
        st.n_inliers, st.n_new_points = n_inl, n_new
        if is_kf:
            self._last_kf = i

        if run_map:
            self._map_block(i, st, bool(is_kf))
        lc = self.loop_closer
        if lc is not None:
            _, det = lc_mod.detect_step(lc.voc, lc.lc, lc._db, self.state, i, bool(is_kf))
            st._set_detect(det)

    def _map_block(self, i: int, st: FrameStats, is_kf: bool) -> None:
        """Fuse, windowed local BA (with `run_ba`) and point cull of frame i.
        At keyframe rate, fuse -> BA -> cull, fusing and culling on keyframe
        blocks only (the reference's LocalMapping cadence; floor and warmup
        blocks solve alone); per frame, BA, then fuse every `fuse_every` and
        cull every `cull_every` frames."""
        cfg = self.cfg
        m = cfg.mapping
        per_frame = not cfg.ba.keyframe_only
        fuse = m.enabled and (bool(m.fuse_every) and i % m.fuse_every == 0 if per_frame else is_kf)
        cull = m.enabled and (bool(m.cull_every) and i % m.cull_every == 0 if per_frame else is_kf)

        def do_fuse():
            r = mapping.fuse(self.state, i, radius_px=m.fuse_radius_px,
                             max_hamming=m.fuse_max_hamming, image_wh=cfg.image_wh)
            self.state, st.n_fused = r.state, r.n_associated

        if fuse and not per_frame:
            do_fuse()
        if self.run_ba:
            r = local_ba.local_bundle_adjust(self.state, i, cfg)
            self.state, st.chi2_before, st.chi2_after = r.state, r.chi2_initial, r.chi2_final
        if fuse and per_frame:
            do_fuse()
        if cull:
            self.state, st.n_culled = mapping.cull_points(
                self.state, i, min_obs=m.cull_min_obs, grace=m.cull_grace)

    # --- lagged host processing: closures, relocalization, FrameCulling ----------
    def _enqueue(self, st: FrameStats) -> None:
        self.stats.append(st)
        if self.loop_closer is None and not self._auto_steer:
            return
        self._pending.append(st)
        self._drain(force=False)

    def _drain(self, force: bool) -> None:
        """Process pending frame outcomes once they are `stat_lag` frames old
        (all of them with `force`)."""
        lag = self.cfg.stat_lag
        if self._cull_pending is not None and (force or self._next - self._cull_pending[2] > lag):
            self._cull_apply()
        while self._pending and (force or len(self._pending) > lag):
            self._process_stat(self._pending.pop(0))

    def _process_stat(self, st: FrameStats) -> None:
        i = st.frame
        self._fold_kf_upto(i + 1)
        if self._auto_steer:
            self._update_steer_health(st)
        lc = self.loop_closer
        if lc is None:
            return
        if not st.tracked:
            self._fail_streak += 1
            if self._fail_streak >= self.cfg.track.reloc_after:
                self._try_relocalize()
            return
        self._fail_streak = 0
        if not st.is_keyframe:
            return
        self._kf_since_cull += 1
        m = self.cfg.mapping
        if (self._kf_since_cull >= m.kf_cull_every and self._cull_pending is None
                and len(self._keyframes_known()) > m.kf_keep_recent + 1):
            self._kf_since_cull = 0
            self._cull_dispatch()
        j = lc.offer(i, st.cand_j, st.cand_score, st.cand_floor, st.cand_n)
        if j is not None and j not in self._kf_culled:
            # the graph spans every ever-promoted keyframe: culled ones keep
            # their poses and stay valid vertices
            with torch.inference_mode():
                self.state, closed = lc.close(self.state, i, j, self.gen,
                                              keyframes=list(self._keyframes))
            st.loop_closed = closed

    def _try_relocalize(self) -> None:
        """Relocalize the newest ingested frame against the BoW-nearest
        resident keyframes (the failure is seen `stat_lag` frames late; the
        newest frame is the one the next step can chain from)."""
        lc = self.loop_closer
        i = self._next - 1
        newest = self.stats[i]
        if newest.tracked:
            self._fail_streak = 0
            return
        if int(self.state.slot_of[i]) < 0:
            return
        with torch.inference_mode():
            scores = lc.reloc_scores(self.state, i).cpu().numpy()
            slot_of = self.state.slot_of.cpu().numpy()
            pose_valid = self.state.pose_valid.cpu().numpy()
            cands = [int(f) for f in np.argsort(-scores)
                     if np.isfinite(scores[f]) and f < i and slot_of[f] >= 0 and pose_valid[f]]
            for cand in cands[: self.cfg.track.reloc_candidates]:
                self.reloc_attempts += 1
                res = tracker.relocalize(self.state, i, cand, self.gen, self.cfg)
                ok, n = torch.stack([res.ok.to(torch.int64), res.n_inliers.to(torch.int64)]).tolist()
                if ok:
                    self.reloc_successes += 1
                    self.state = res.state
                    newest.tracked = True
                    newest.n_inliers = n
                    self._fail_streak = 0
                    return

    def _cull_dispatch(self) -> None:
        """FrameCulling on the current state; its flags are applied
        `stat_lag` frames later, as in the reference."""
        m = self.cfg.mapping
        kfs = self._keyframes_known() if self.loop_closer is not None else self.keyframes
        if len(kfs) <= m.kf_keep_recent + 1:
            return
        F = self.cfg.max_frames
        flags = np.zeros(F, bool)
        flags[kfs] = True
        protect = np.zeros(F, bool)
        protect[kfs[0]] = True
        protect[kfs[-m.kf_keep_recent:]] = True
        with torch.inference_mode():
            flags_dev = kf_mod.cull_frames_device(
                self.state, flags, protect, redundancy=m.kf_cull_redundancy,
                min_other_obs=m.kf_cull_min_other_obs)
        self._cull_pending = (flags_dev, kfs, self._next)

    def _cull_apply(self) -> list[int]:
        if self._cull_pending is None:
            return []
        flags_dev, kfs, _ = self._cull_pending
        self._cull_pending = None
        new_flags = flags_dev.cpu().numpy()
        culled = [f for f in kfs if not new_flags[f]]
        self._kf_culled.update(culled)
        if culled and self.loop_closer is not None:
            # culled keyframes leave the candidate set and the floor; their
            # remembered loop edges stay (the pose is still a graph vertex)
            self.loop_closer.clear_rows(culled)
        return culled

    def cull_redundant_keyframes(self) -> list[int]:
        """Synchronous FrameCulling pass; returns the newly culled frames."""
        self._cull_apply()
        self._cull_dispatch()
        return self._cull_apply()

    def _fold_kf_upto(self, n: int) -> None:
        while self._kf_scanned < n:
            s = self.stats[self._kf_scanned]
            if s.is_keyframe:
                self._keyframes.append(s.frame)
            self._kf_scanned += 1

    def _keyframes_known(self) -> list[int]:
        return [f for f in self._keyframes if f not in self._kf_culled]

    def flush(self) -> None:
        """Process every pending per-frame outcome now."""
        self._drain(force=True)

    # --- outputs ---------------------------------------------------------------
    @property
    def keyframes(self) -> list[int]:
        """Live keyframes (FrameCulling victims excluded); processes pending
        outcomes first."""
        self._drain(force=True)
        self._fold_kf_upto(len(self.stats))
        return self._keyframes_known()

    def trajectory(self):
        """(poses (n, 3, 4), valid (n,), timestamps (n,)) as numpy, after
        pending loop-closure work."""
        self._drain(force=True)
        n = self._next
        return (
            self.state.poses[:n].cpu().numpy(),
            self.state.pose_valid[:n].cpu().numpy(),
            np.asarray(self.timestamps, dtype=np.float64),
        )

    def map_points(self) -> np.ndarray:
        self._drain(force=True)
        pts = self.state.points.cpu().numpy()
        return pts[self.state.point_valid.cpu().numpy()]

    @property
    def n_map_points(self) -> int:
        return int(self.state.n_points)

