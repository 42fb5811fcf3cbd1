"""SlamSession — the host loop over the SLAM stages and the per-frame step
program (counterpart of `monocular_slam_tpu/slam/session.py`).

Frame 0 is the reference; later frames bootstrap against it until the
two-view map is accepted; every frame after that runs one step:
`session_step` (`track_step`: tracking and the keyframe rule; then
`mapping_block`), inside `image_session_step` for an image (`image_ingest`:
ORB extraction on K1, undistortion, state ingest first), then `pack_step`
(loop-closure detection with a closer attached, and ONE packed int32
vector of the frame's outcomes). The mapping
block runs, as in the reference, either at keyframe rate plus the cadence
floor and warmup (fuse -> windowed local BA -> cull;
`BAConfig.keyframe_only`, the default) or on every tracked frame (local BA,
then fuse every `fuse_every` and cull every `cull_every` frames), each part
under `utils/graph.cond`, the counterpart of the reference's `lax.cond`.

The step functions take the frame id, the feature slot, the image buffer
index, the last keyframe and the PnP key as 0-d (key: (2,)) device
tensors, as the reference traces them. On a card the session captures them
into CUDA graphs (`utils/graph.Program`), the counterpart of the
reference's `jax.jit` of the step, and keeps the state in static device
buffers that the graphs update in place. The card's torch (2.11) has no
conditional graph nodes, so a tracked frame is TWO replays: the tracked
part (ingest, extraction, `track_step`) captured per (path, steering mode,
frame layout), then, after ONE host read of its flags, the mapping program
that matches `mapping_predicates` (the mapping block's parts decided, then
detection and the packed vector), captured per decision and closer. Per
tracked frame the host allocates the feature slot, splits the keys (the
session's `_split`, then `tracker.track`'s `split(key)[0]`), writes [i,
slot, j, key words, k, dist] into a pinned ring row, issues one H2D copy,
replays the tracked part, reads its six flags, replays the mapping program
and issues one D2H copy of the packed vector into the ring with an event.
`FrameStats` reads that row once the event is done; the session acts on
outcomes `stat_lag` frames late, as the reference does (keyframe folding,
steering health, closures, relocalization after `reloc_after` failures,
FrameCulling every `kf_cull_every` keyframes).

Every other device stage is a program too (`_run`), each the counterpart
of one of the reference's compiled programs, reading its inputs from
static control words (`graph.Words`, one host-to-device copy) and writing
the state in place: an untracked frame's ingest and the bootstrap
(captured in `prewarm`, as the reference compiles `_bootstrap` there),
relocalization and its BoW scores, FrameCulling and its database clear,
and the loop closer's Sim3, correction and global BA (captured at first
use). Between programs the host reads only what the reference reads, each
with one copy behind an event (`graph.Readback`). A capture, build or
launch failure raises: nothing on a card runs op by op unless the private
`_use_graphs` switch is cleared before the first frame (the A/B of
`chip_smoke.py`). On the CPU the same functions run op by op, and
`graph.cond` reads each predicate.

The session is keyed like the reference: `PRNGKey(seed)`, split once per
bootstrap attempt, tracked frame, closure and relocalization candidate, at
the reference's call sites and in its order (`_split`). Each RANSAC makes
its uniforms from its key on the session's device (`utils/prng.py`), so the
same seed gives the reference's draws and its trajectory.

`prewarm` pays the one-time costs (kernel builds, captures, functorch's
first-use imports) before frame 0; `add_frame_from_buffer` takes frames
from a buffer already on the device.

`SlamSession(..., trace=True)` records into `sess.tracer`
(`utils/profiling.Tracer`): per frame the spans `frame` (the whole
`add_*` call), `prep` (undistortion, slot, keys, control words, staging),
`launch.track`, `wait.flags` and `launch.map` (the host inside the two
replays and blocked on the flags between them), `drain` (the lagged
processing) with a `program.<kind>` span per `_run` and a `capture` span
per capture, each carrying the frame whose outcome it processes; the
device's clock at the tracked step's parts, stamped inside its programs
(`Tracer.mark`) and brought back with the ring row (`FrameStats.device_ms`);
and per frame the host's waits (flag reads, `Readback` reads, `FrameStats`
and `Words` waits that blocked), replays and captures. Off (the default),
`tracer` is None and the programs are the same, node for node.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from monocular_slam_tpu_torch.geometry import alignment, sim3
from monocular_slam_tpu_torch.geometry import camera as cam
from monocular_slam_tpu_torch.ops import fast_score, hamming, launches, orb, small_eigh
from monocular_slam_tpu_torch.ops import features as features_mod
from monocular_slam_tpu_torch.optim import pose_graph
from monocular_slam_tpu_torch.slam import keyframes as kf_mod
from monocular_slam_tpu_torch.slam import local_ba, mapping, tracker
from monocular_slam_tpu_torch.slam import loop_closer as lc_mod
from monocular_slam_tpu_torch.slam import state as state_mod
from monocular_slam_tpu_torch.slam.config import SlamConfig
from monocular_slam_tpu_torch.slam.state import SlamState
from monocular_slam_tpu_torch.utils import graph, prng, profiling
from monocular_slam_tpu_torch.utils.device import resolve_device
from monocular_slam_tpu_torch.utils.scatter import mark, take

# the packed per-frame vector: the int32 fields, then the float32 fields
# bitcast into int32 lanes (the reference's layout, session.py:38-44)
_I32_FIELDS = (
    "tracked", "n_inliers", "n_new_points", "n_fused", "n_culled",
    "is_keyframe", "last_kf", "cand_j", "cand_n",
)
_F32_FIELDS = ("chi2_before", "chi2_after", "cand_score", "cand_floor")
_BOOL_FIELDS = frozenset({"tracked", "is_keyframe"})
PACKED_LEN = len(_I32_FIELDS) + len(_F32_FIELDS)
# a ring row's control words: i, slot, j, the PnP key's two words, then the
# float32 bits of k (4) and dist (5)
_CTRL_LEN = 14


def unpack(packed: np.ndarray) -> dict:
    """The fields of one packed vector (host int32 array)."""
    n_i = len(_I32_FIELDS)
    vals = {n: (bool(x) if n in _BOOL_FIELDS else int(x))
            for n, x in zip(_I32_FIELDS, packed[:n_i])}
    vals.update({n: float(x) for n, x in zip(_F32_FIELDS, packed[n_i:].view(np.float32))})
    return vals


class FrameStats:
    """Per-frame outcomes. A tracked frame's values arrive as one packed
    int32 vector in a host ring row, copied there from the device behind an
    event; reading any field resolves the row once (waiting on the event
    only if the device has not reached it yet). `launches` is, for a
    tracked step, the launches of each kernel (`ops/launches.KERNELS`) that
    the card counted between the step's start and end, else None.
    `device_ms` is, for a tracked step of a tracing session, the device
    milliseconds of each of its parts that ran (`profiling.stamp_ms`), else
    None."""

    __slots__ = ("frame", "loop_closed", "_row", "_counts", "_event", "_stamps", "_vals")
    waits = 0  # resolutions in this process that had to wait on the device

    def __init__(self, frame: int, **kw):
        object.__setattr__(self, "frame", frame)
        object.__setattr__(self, "loop_closed", False)
        object.__setattr__(self, "_row", None)
        object.__setattr__(self, "_counts", None)
        object.__setattr__(self, "_event", None)
        object.__setattr__(self, "_stamps", None)
        vals = {
            "tracked": False, "n_inliers": 0, "n_new_points": 0,
            "n_fused": 0, "n_culled": 0, "is_keyframe": False,
            "last_kf": -1, "cand_j": -1, "cand_n": 0,
            "chi2_before": math.nan, "chi2_after": math.nan,
            "cand_score": 0.0, "cand_floor": 0.0, "launches": None, "device_ms": None,
        }
        vals.update(kw)
        object.__setattr__(self, "_vals", vals)

    def _set_host(self, row: torch.Tensor, counts: torch.Tensor, event, stamps) -> None:
        object.__setattr__(self, "_row", row)
        object.__setattr__(self, "_counts", counts)
        object.__setattr__(self, "_event", event)
        object.__setattr__(self, "_stamps", stamps)

    def _resolve(self) -> None:
        row = self._row
        if row is None:
            return
        ev = self._event
        if ev is not None and not ev.query():
            FrameStats.waits += 1
            ev.synchronize()
        self._vals.update(unpack(row.numpy()))
        c = self._counts.numpy()
        self._vals["launches"] = dict(zip(launches.KERNELS, (int(n) for n in c[1] - c[0])))
        if self._stamps is not None:
            self._vals["device_ms"] = profiling.stamp_ms(self._stamps.numpy())
            object.__setattr__(self, "_stamps", None)
        object.__setattr__(self, "_row", None)
        object.__setattr__(self, "_counts", None)
        object.__setattr__(self, "_event", None)

    def __getattr__(self, name):
        vals = object.__getattribute__(self, "_vals")
        if name in vals:
            FrameStats._resolve(self)
            return vals[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in FrameStats.__slots__:
            object.__setattr__(self, name, value)
        else:
            FrameStats._resolve(self)
            self._vals[name] = value

    def __repr__(self):  # resolves: a debugging aid
        self._resolve()
        return f"FrameStats(frame={self.frame}, {self._vals})"


class StepStats(NamedTuple):
    tracked: torch.Tensor
    n_inliers: torch.Tensor
    n_new_points: torch.Tensor
    chi2_before: torch.Tensor
    chi2_after: torch.Tensor
    n_fused: torch.Tensor
    n_culled: torch.Tensor
    is_keyframe: torch.Tensor
    last_kf: torch.Tensor


class TrackOut(NamedTuple):
    """What the tracked part of the step hands the mapping block."""

    state: SlamState
    ok: torch.Tensor
    n_inliers: torch.Tensor
    n_new_points: torch.Tensor
    is_keyframe: torch.Tensor
    run_map: torch.Tensor
    last_kf: torch.Tensor


def track_step(state: SlamState, i: torch.Tensor, last_kf: torch.Tensor, pnp_key: torch.Tensor,
               cfg: SlamConfig) -> TrackOut:
    """PnP track of frame i and the keyframe rule: first tracked frame,
    overlap with the last keyframe dropped, or max gap exceeded (an evicted
    last keyframe counts as 0 overlap). `run_map` is the keyframe-rate
    mapping block's predicate (keyframe, cadence floor, warmup)."""
    i = i.reshape(()).long()
    last_kf = last_kf.reshape(()).to(torch.int32)
    m = cfg.mapping
    tres = tracker.track(state, i, None, cfg, pnp_key=pnp_key)
    state = tres.state
    kf0 = torch.clamp(last_kf, min=0)
    kf_resident = take(state.slot_of, kf0) >= 0
    ov = torch.where(kf_resident, mapping.frame_overlap(state, i, kf0), 0.0)
    is_kf = tres.ok & ((last_kf < 0) | (ov < m.keyframe_overlap)
                       | (i - last_kf >= m.keyframe_max_gap))
    run_map = is_kf
    if cfg.ba.cadence_floor:
        run_map = run_map | (tres.ok & (i % cfg.ba.cadence_floor == 0))
    if cfg.ba.warmup_frames:
        run_map = run_map | (tres.ok & (i < cfg.ba.warmup_frames))
    return TrackOut(state, tres.ok, tres.n_pnp_inliers, tres.n_new_points, is_kf, run_map,
                    torch.where(is_kf, i.to(torch.int32), last_kf))


def mapping_predicates(i, ok, is_kf, run_map, cfg: SlamConfig, run_ba: bool):
    """(fuse, local BA, cull) predicates of the mapping block: device bools
    from `track_step`'s tensors, or host bools from host values (the card's
    session decides which mapping program to replay with them). Parts the
    configuration disables are False."""
    m = cfg.mapping
    if cfg.ba.keyframe_only:
        fuse, ba, cull = is_kf, run_map, is_kf
    else:
        fuse = ok & (i % m.fuse_every == 0) if m.fuse_every else False
        ba = ok
        cull = ok & (i % m.cull_every == 0) if m.cull_every else False
    return (fuse if m.enabled else False, ba if run_ba else False,
            cull if m.enabled else False)


def mapping_block(state: SlamState, i: torch.Tensor, preds, cfg: SlamConfig, mark=None):
    """The mapping block under `graph.cond`, as the reference's `lax.cond`s:
    at keyframe rate fuse -> windowed local BA -> cull, per frame local BA
    -> fuse -> cull, each under its predicate of `mapping_predicates` (the
    reference nests the keyframe-rate fuse and cull conds inside its
    `run_map` cond; here they are siblings, which runs the same work since
    a keyframe always runs the block). A tracing session's `mark(part)`
    stamps the end of each part that runs (`Tracer.mark`). Returns (state,
    chi2_before, chi2_after, n_fused, n_culled)."""
    dev = state.poses.device
    i = i.reshape(()).long()
    m = cfg.mapping
    fuse, ba, cull = preds
    nan = torch.full((), math.nan, dtype=state.poses.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def _fuse(st):
        r = mapping.fuse(st, i, radius_px=m.fuse_radius_px, max_hamming=m.fuse_max_hamming,
                         image_wh=cfg.image_wh)
        if mark is not None:
            mark("fuse")
        return r.state, r.n_associated.to(torch.int32)

    def _cull(st):
        r = mapping.cull_points(st, i, min_obs=m.cull_min_obs, grace=m.cull_grace)
        if mark is not None:
            mark("cull")
        return r[0], r[1].to(torch.int32)

    def _ba(st):
        r = local_ba.local_bundle_adjust(st, i, cfg)
        if mark is not None:
            mark("local_ba")
        return r.state, r.chi2_initial, r.chi2_final

    def _pass(st):
        return st, zero

    n_fused = n_culled = zero
    chi2_0 = chi2_1 = nan
    if cfg.ba.keyframe_only and fuse is not False:
        state, n_fused = graph.cond(fuse, _fuse, _pass, state)
    if ba is not False:
        state, chi2_0, chi2_1 = graph.cond(ba, _ba, lambda st: (st, nan, nan), state)
    if not cfg.ba.keyframe_only and fuse is not False:
        state, n_fused = graph.cond(fuse, _fuse, _pass, state)
    if cull is not False:
        state, n_culled = graph.cond(cull, _cull, _pass, state)
    return state, chi2_0, chi2_1, n_fused, n_culled


def session_step(state: SlamState, i: torch.Tensor, last_kf: torch.Tensor,
                 pnp_key: torch.Tensor, cfg: SlamConfig,
                 run_ba: bool, mark=None) -> tuple[SlamState, StepStats]:
    """One step for an initialized session (the reference's
    `_session_step`): `track_step`, then `mapping_block`. `i` and `last_kf`
    are 0-d device tensors, `pnp_key` the (2,) int64 device words of
    `split(key)[0]` for the session's subkey `key` (`prng.key_on`). A
    tracing session's `mark` stamps the tracker's end, the mapping block's
    start and its parts."""
    t = track_step(state, i, last_kf, pnp_key, cfg)
    if mark is not None:
        mark("tracker")
        mark("map_start")
    preds = mapping_predicates(i.reshape(()).long(), t.ok, t.is_keyframe, t.run_map, cfg, run_ba)
    state, chi2_0, chi2_1, n_fused, n_culled = mapping_block(t.state, i, preds, cfg, mark)
    return state, StepStats(
        tracked=t.ok, n_inliers=t.n_inliers, n_new_points=t.n_new_points,
        chi2_before=chi2_0, chi2_after=chi2_1, n_fused=n_fused, n_culled=n_culled,
        is_keyframe=t.is_keyframe, last_kf=t.last_kf,
    )


def image_ingest(state: SlamState, img: torch.Tensor, i: torch.Tensor, slot: torch.Tensor,
                 k: torch.Tensor, dist: torch.Tensor, cfg: SlamConfig,
                 undistort: bool = True) -> SlamState:
    """ORB extraction (`cfg.frontend.steer_mode` is "binned" or
    "continuous") -> keypoint undistortion (identity at zero coefficients,
    up to its rounding) -> state ingest into `slot`. Without `undistort`
    the keypoints go in as extracted: the reference's untracked frames
    (frame 0, the bootstrap attempts) take its feature path, which
    undistorts only at nonzero coefficients."""
    fe = cfg.frontend
    feats = features_mod.extract(img.to(torch.float32), n_features=fe.n_features,
                                 n_levels=fe.n_levels, fast_threshold=fe.fast_threshold,
                                 steer_mode=fe.steer_mode)
    uv = cam.undistort_pixels(k, dist, feats.uv) if undistort else feats.uv
    return state_mod.add_frame_features(state, i, slot, uv, feats.scale, feats.valid,
                                        feats.desc, feats.desc_pm1, k)


def image_session_step(state: SlamState, img: torch.Tensor, i: torch.Tensor, slot: torch.Tensor,
                       last_kf: torch.Tensor, pnp_key: torch.Tensor, k: torch.Tensor,
                       dist: torch.Tensor, cfg: SlamConfig,
                       run_ba: bool) -> tuple[SlamState, StepStats]:
    """ONE step for a tracked image (the reference's `_image_session_step`):
    `image_ingest`, then `session_step`."""
    state = image_ingest(state, img, i, slot, k, dist, cfg)
    return session_step(state, i, last_kf, pnp_key, cfg, run_ba)


def pack_step(state: SlamState, stats: StepStats, db, i: torch.Tensor, voc, lcfg):
    """Fused loop-closure detection (with a vocabulary; `db` is updated in
    place) and the packed int32 vector of the step's outcomes (the
    reference's `_pack_step`). Returns (state, db, last_kf, packed)."""
    dev = state.poses.device
    if voc is None:
        det = lc_mod.null_detect_out(dev)
    else:
        db, det = lc_mod.detect_step(voc, lcfg, db, state, i, stats.is_keyframe)
    i32 = torch.stack([
        stats.tracked.to(torch.int32), stats.n_inliers.to(torch.int32),
        stats.n_new_points.to(torch.int32), stats.n_fused.to(torch.int32),
        stats.n_culled.to(torch.int32), stats.is_keyframe.to(torch.int32),
        stats.last_kf.to(torch.int32), det.best_j.to(torch.int32), det.n_cand.to(torch.int32),
    ])
    f32 = torch.stack([
        stats.chi2_before.to(torch.float32), stats.chi2_after.to(torch.float32),
        det.score.to(torch.float32), det.floor.to(torch.float32),
    ])
    return state, db, stats.last_kf, torch.cat([i32, f32.view(torch.int32)])


class _Row:
    """One ring row: host control words, the host image staging buffers,
    the packed stats' host copy, the kernels' launch counters at the step's
    start and end, a tracing session's device stamps (else None), the event
    behind them and the frame that owns it."""

    def __init__(self, pin: bool, stamps: bool = False):
        self.pin = pin
        self.ctrl = torch.zeros(_CTRL_LEN, dtype=torch.int64, pin_memory=pin)
        self.stats = torch.zeros(PACKED_LEN, dtype=torch.int32, pin_memory=pin)
        self.counts = torch.zeros((2, len(launches.KERNELS)), dtype=torch.int64, pin_memory=pin)
        self.stamps = (torch.zeros(len(profiling.SLOTS), dtype=torch.int64, pin_memory=pin)
                       if stamps else None)
        self.event = torch.cuda.Event() if pin else None
        self.images: dict = {}  # (shape, dtype) -> host staging tensor
        self.owner: FrameStats | None = None

    def image(self, arr: np.ndarray) -> torch.Tensor:
        key = (arr.shape, arr.dtype.str)
        buf = self.images.get(key)
        if buf is None:
            buf = self.images[key] = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                                                 pin_memory=self.pin)
        buf.numpy()[...] = arr
        return buf


class SlamSession:
    """Feed frames (images or precomputed features), get trajectory + map.

        sess = SlamSession(cfg, seed=1)            # on the card
        for img, ts in frames:
            sess.add_frame(img, k=K, timestamp=ts)
        poses, valid, stamps = sess.trajectory()

    With loop closing: `SlamSession(cfg, loop_closer=LoopCloser(
    vocabulary.load_default(), cfg))`. `device` defaults to the card and
    raises without one; pass `device="cpu"` to run on the CPU. On a card,
    `state` is the set of static buffers the captured step updates in
    place: copy what you keep. With `trace`, `tracer` records the frames'
    spans, device stamps and counters (the module's docstring); else it is
    None.
    """

    def __init__(self, cfg: SlamConfig = SlamConfig(), seed: int = 0,
                 run_ba: bool = True, loop_closer: lc_mod.LoopCloser | None = None,
                 device=None, trace: bool = False):
        self.cfg = cfg
        self.run_ba = run_ba
        self.device = resolve_device(device)
        self.loop_closer = loop_closer
        self._state: SlamState = state_mod.empty_state(cfg, self.device)
        self.key = prng.PRNGKey(seed)
        self.stats: list[FrameStats] = []
        self.timestamps: list[float] = []
        self._next = 0
        self._initialized = False
        self._init_ref = 0
        self._last_kf = torch.full((), -1, dtype=torch.int32, device=self.device)
        self._keyframes: list[int] = []  # folded from stats, `stat_lag` frames late
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

        cuda = self.device.type == "cuda"
        self._use_graphs = cuda  # the captured programs; cleared only by chip_smoke's A/B
        self.tracer = profiling.Tracer(self.device) if trace else None
        self._ring = [_Row(pin=cuda, stamps=trace) for _ in range(cfg.stat_lag + 1)]
        self._ring_next = 0
        # the session's programs (and its loop closer's): one stream, one pool
        self._graphs = graph.Programs(self.device) if cuda else None
        if self._graphs is not None:
            self._graphs.tracer = self.tracer
        self._io = graph.Statics(self.device)  # static inputs and outputs of the programs
        self.flag_reads = 0  # host reads of the mapping block's predicates (one a frame)
        self._calls: list = []  # (program kind, launch counters and events before, after)

    # --- the loop closer: attached, it runs its programs through the session ------
    @property
    def loop_closer(self) -> lc_mod.LoopCloser | None:
        return self._loop_closer

    @loop_closer.setter
    def loop_closer(self, lc: lc_mod.LoopCloser | None) -> None:
        if lc is not None:
            if lc.device != self.device:
                raise ValueError(f"loop closer on {lc.device}, session on {self.device}")
            lc.attach(self)
        self._loop_closer = lc

    # --- the programs ------------------------------------------------------------
    @property
    def capture_s(self) -> dict:
        """Program key -> seconds its capture took."""
        return {} if self._graphs is None else self._graphs.capture_s

    @property
    def _pool(self):
        return None if self._graphs is None else self._graphs.pool

    def _run(self, key, fn):
        """Program `key`. `fn(commit)` reads the programs' static inputs and
        the state and, when `commit`, writes its results to the state and to
        static outputs; it returns the tensors a later program of the same
        sequence reads. On the card's graph route `fn` is captured at the
        program's first use (its warm-up run commits nothing) and replayed;
        otherwise (the CPU, the card's op-by-op A/B) it runs once with
        `commit`. On the card the kernels' counters are copied on the
        device, and an event recorded, around the call (`program_calls`).
        A tracing session's `program.<kind>` span covers the call."""
        tr = self.tracer
        span = None if tr is None else tr.begin(f"program.{key[0]}", key)
        cuda = self.device.type == "cuda"
        if cuda:
            graph_ready = not self._use_graphs or key in self._graphs.programs
            if not graph_ready:  # its capture, before the call's counters
                self._graphs.get(key, lambda: fn(graph.capturing()))
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = launches.counters(self.device).clone()
            ev0.record()
        with torch.inference_mode():
            if self._use_graphs:
                out = self._graphs.get(key, lambda: fn(graph.capturing())).replay()
            else:
                out = fn(True)
        if cuda:
            ev1.record()
            self._calls.append((key, before, launches.counters(self.device).clone(), ev0, ev1))
        if span is not None:
            tr.end(span)
        return out

    @property
    def program_calls(self) -> list[dict]:
        """Every program call of the session outside the tracked step, in
        order: its key and kind (the key's first part), the kernels'
        launches the card counted in it and its device milliseconds between
        two events (waits for the card: call it after the run)."""
        return [{"kind": key[0], "key": key, "launches": dict(zip(launches.KERNELS,
                                                                  (b - a).tolist())),
                 "ms": e0.elapsed_time(e1)} for key, a, b, e0, e1 in self._calls]

    # --- the state: static device buffers on the graph route ------------------
    @property
    def state(self) -> SlamState:
        return self._state

    @state.setter
    def state(self, new: SlamState) -> None:
        if not self._use_graphs:
            self._state = new
            return
        for buf, x in zip(self._state, new):
            if x is not buf:
                buf.copy_(x)

    def _split(self) -> np.ndarray:
        """The next subkey: `key, sub = split(key)`, on the host."""
        self.key, sub = prng.split(self.key)
        return sub

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
        Returns (slot, evicted frame or -1). Keyframe flags lag by
        `stat_lag` frames; lagging keyframes are inside the protected window
        anyway."""
        if self._free_slots:
            slot = self._free_slots.pop()
            self._slot_frame[slot] = i
            return slot, -1
        protect_after = i - self._protect_window
        kfs = set(self._keyframes_known())
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

    def add_frame(self, img, k, timestamp: float = 0.0, dist=None) -> FrameStats:
        """Ingest a grayscale (H, W) image in [0, 255] (numpy or tensor).
        Once initialized, a frame is one step (on a card, one replay); a
        host array reaches the card through the pinned ring."""
        return self._frame("image", img, k, timestamp, dist)

    def add_frame_from_buffer(self, buffer: torch.Tensor, idx: int, k, timestamp: float = 0.0,
                              dist=None) -> FrameStats:
        """Ingest frame `idx` of an (N, H, W) uint8 or float32 image buffer
        that already lies on the session's device: the frame is sliced and
        converted there (inside the captured step on a card), with no
        host-to-device copy of the image."""
        if buffer.device.type != self.device.type or buffer.dim() != 3:
            raise ValueError(f"add_frame_from_buffer takes an (N, H, W) buffer on {self.device}, "
                             f"got {tuple(buffer.shape)} on {buffer.device}")
        return self._frame("buffer", buffer, k, timestamp, dist, j=idx)

    def add_frame_features(self, feats: orb.Features, k, timestamp: float,
                           dist=None) -> FrameStats:
        """Ingest precomputed features; `dist` (radtan 5-vector) undistorts
        the keypoints first when nonzero."""
        return self._frame("features", feats, k, timestamp, dist)

    def _frame(self, path: str, frame, k, timestamp: float, dist, j: int = 0) -> FrameStats:
        """The frame's step once initialized (two frames in), else its
        untracked ingest; a tracing session's `frame` span around it."""
        step = self._tracked if self._initialized and self._next >= 2 else self._untracked
        if self.tracer is None:
            return step(path, frame, k, timestamp, dist, j)
        with self._frame_span():
            return step(path, frame, k, timestamp, dist, j)

    def _host_syncs(self) -> int:
        """The host's waits on the card so far: this session's flag reads,
        and this process's `Readback` reads and `FrameStats` and `Words`
        waits that blocked."""
        return self.flag_reads + graph.Readback.reads + FrameStats.waits + graph.Words.waits

    @contextlib.contextmanager
    def _frame_span(self):
        """The `frame` span of frame `_next`, and its counters: the host's
        waits, the replays and the captures inside it."""
        tr, i = self.tracer, self._next
        tr.frame = i
        before = (self._host_syncs(), graph.Program.replays, len(self.capture_s))
        span = tr.begin("frame")
        try:
            yield
        finally:
            tr.end(span)
            after = (self._host_syncs(), graph.Program.replays, len(self.capture_s))
            tr.counters[i] = dict(zip(profiling.COUNTERS, (b - a for a, b in zip(before, after))))

    def _host_undistort(self, path: str, frame, k, dist):
        """Precomputed features with a nonzero `dist` are undistorted before
        they reach a program (an image's keypoints are, inside it)."""
        if path == "features" and dist is not None and np.any(np.asarray(dist) != 0):
            with torch.inference_mode():
                frame = frame._replace(uv=cam.undistort_pixels(self._k(k), self._k(dist), frame.uv))
            dist = None
        return frame, dist

    def _untracked(self, path: str, frame, k, timestamp: float, dist, j: int = 0) -> FrameStats:
        """Frame 0 and the bootstrap attempts: the frame's ingest program
        (the reference's extraction and `_add_feats`), then after frame 0
        the bootstrap program against the reference frame and ONE host read
        of its (ok, n_inliers, n_points). A success also inserts the frame's
        BoW row, the map's first anchor for closure, inside the program."""
        i = self._next
        if i >= self.cfg.max_frames:
            raise ValueError(f"frame capacity {self.cfg.max_frames} exhausted")
        tr = self.tracer
        prep = None if tr is None else tr.begin("prep")
        frame, dist = self._host_undistort(path, frame, k, dist)
        steer = None if path == "features" else self._steer
        # the reference's untracked frames take its feature path: keypoints
        # undistorted only at nonzero coefficients
        undistort = path != "features" and dist is not None and bool(np.any(np.asarray(
            dist.cpu() if torch.is_tensor(dist) else dist) != 0))
        slot, prev = self._acquire_slot(i)
        row = self._acquire_row()
        try:
            self._ctrl_words(row, i, slot, j, k, dist, np.zeros(2, np.uint32))
            if path == "image" and not torch.is_tensor(frame):
                frame = row.image(np.asarray(frame))
            self._ingest_frame(path, steer, frame, row, undistort, prep)
        except Exception:
            self._release_slot(slot, prev)
            raise
        self._next += 1
        self.timestamps.append(float(timestamp))
        st = FrameStats(frame=i)
        if i == 0:
            st.tracked = True
        else:
            words = self._io.words("boot_in", 4).fill([self._init_ref, i], self._split())
            out = self._io.readback("boot_out", 3)
            self._run(("bootstrap", id(self.loop_closer)), self._bootstrap_fn(words, out))
            ok, n_inl, n_pts = (int(x) for x in out.start().get())
            st.tracked = bool(ok)
            st.n_inliers = n_inl
            st.n_new_points = n_pts
            if st.tracked:
                self._initialized = True
                st.is_keyframe = True
                self._last_kf.fill_(i)
            elif i - self._init_ref >= self.cfg.init.max_defer:
                self._init_ref = i - 1
        st.last_kf = i if st.is_keyframe else -1
        self._enqueue(st)
        return st

    def _bootstrap_fn(self, words: torch.Tensor, out: graph.Readback):
        """The bootstrap program (the reference's `_bootstrap`): the two-view
        map between frames f0 and f1 (control words f0, f1, the key's two
        words), and with a loop closer frame f1's BoW row where it
        succeeds."""
        cfg, lc = self.cfg, self.loop_closer

        def fn(commit: bool):
            f0, f1, key = words[0], words[1], words[2:4]
            res = tracker.bootstrap(self.state, key, cfg, f0, f1)
            if lc is not None:
                db = lc._db
                row = torch.where(res.ok, lc._bow_of(res.state, f1), take(db, f1))
            if commit:
                self.state = res.state
                out.dev.copy_(graph.pack([res.ok, res.n_inliers, res.n_points]))
                if lc is not None:
                    db.index_copy_(0, f1.reshape(1), row[None])

        return fn

    def _layout(self, path: str, frame):
        """What a frame program's capture depends on besides its path."""
        return ((frame.data_ptr(), tuple(frame.shape), frame.dtype) if path == "buffer"
                else tuple(frame.shape) if path == "image" else None)

    def _ingest_fn(self, path: str, steer, ctrl: torch.Tensor, src, undistort: bool):
        def fn(commit: bool):
            state = self._ingest_step(path, steer, self.state, ctrl, src, undistort)
            if commit:
                self.state = state

        return fn

    def _stage(self, path: str, frame) -> None:
        """A frame's image or features into the programs' static inputs."""
        if path == "image":
            self._static_input(path, frame).copy_(frame, non_blocking=True)
        elif path == "features":
            for buf, x in zip(self._static_input(path, frame), frame):
                buf.copy_(x, non_blocking=True)

    def _ingest_frame(self, path: str, steer, frame, row: _Row, undistort: bool,
                      prep) -> None:
        """An untracked frame's ingest program: the control words of `row`
        and the frame staged into the static inputs on the graph route, as
        the tracked part of the step takes them (the end of span `prep`)."""
        if self._use_graphs:
            ctrl, _ = self._io_buffers()
            ctrl.copy_(row.ctrl, non_blocking=True)
            self._stage(path, frame)
            src = self._static_input(path, frame)
        else:
            ctrl = row.ctrl.to(self.device, copy=True)  # the row is reused
            src = frame.to(self.device) if path == "image" else frame
        if prep is not None:
            self.tracer.end(prep)
        self._run(("ingest", path, steer, self._layout(path, frame), undistort),
                  self._ingest_fn(path, steer, ctrl, src, undistort))

    # --- the tracked step ---------------------------------------------------------
    def _acquire_row(self) -> _Row:
        """The next ring row, after its previous frame's outcomes are read
        (so its host buffers are no longer in flight)."""
        row = self._ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % len(self._ring)
        if row.owner is not None:
            row.owner._resolve()
            row.owner = None
        return row

    def _ctrl_words(self, row: _Row, i: int, slot: int, j: int, k, dist, pnp) -> None:
        kd = np.zeros(9, np.float32)
        kd[:4] = np.asarray(k.cpu() if torch.is_tensor(k) else k, np.float32).reshape(4)
        if dist is not None:
            kd[4:] = np.asarray(dist.cpu() if torch.is_tensor(dist) else dist,
                                np.float32).reshape(5)
        words = np.concatenate([[i, slot, j], pnp.astype(np.int64),
                                kd.view(np.int32).astype(np.int64)])
        row.ctrl.numpy()[:] = words

    def _cfg_for(self, steer: str | None) -> SlamConfig:
        if steer is None:
            return self.cfg
        return dataclasses.replace(self.cfg, frontend=dataclasses.replace(self.cfg.frontend,
                                                                          steer_mode=steer))

    def _closer_args(self):
        lc = self.loop_closer
        return (None, None, None) if lc is None else (lc._db, lc.voc, lc.lc)

    @staticmethod
    def _unpack_ctrl(ctrl: torch.Tensor):
        """(i, slot, j, pnp_key, k, dist) device views of the control words."""
        kd = ctrl[5:14].to(torch.int32).view(torch.float32)
        return ctrl[0], ctrl[1], ctrl[2], ctrl[3:5], kd[:4], kd[4:]

    def _ingest_step(self, path: str, steer: str | None, state, ctrl, frame,
                     undistort: bool = True):
        """The frame's ingest (and extraction) for `path`; an image's
        keypoints undistorted unless `undistort` is False (`image_ingest`)."""
        i, slot, j, _, k, dist = self._unpack_ctrl(ctrl)
        if path == "features":
            return state_mod.add_frame_features(state, i, slot, frame.uv, frame.scale,
                                                frame.valid, frame.desc, frame.desc_pm1, k)
        img = frame.index_select(0, j.reshape(1))[0] if path == "buffer" else frame
        return image_ingest(state, img, i, slot, k, dist, self._cfg_for(steer), undistort)

    def _static_input(self, path: str, frame):
        """The static device tensor(s) a program reads its frame from."""
        if path == "buffer":
            return frame
        if path == "image":
            key = ("image", tuple(frame.shape))
            if key not in self._io:
                self._io[key] = torch.zeros(tuple(frame.shape), dtype=torch.float32,
                                            device=self.device)
            return self._io[key]
        if "features" not in self._io:
            N = self.cfg.frontend.n_features
            d = self.device
            self._io["features"] = orb.Features(
                uv=torch.zeros((N, 2), device=d), desc=torch.zeros((N, 8), dtype=torch.int32,
                                                                   device=d),
                desc_pm1=torch.zeros((N, 256), dtype=torch.int8, device=d),
                angle=torch.zeros(N, device=d), score=torch.zeros(N, device=d),
                scale=torch.ones(N, device=d), valid=torch.zeros(N, dtype=torch.bool, device=d))
        return self._io["features"]

    def _io_buffers(self):
        """The control words and the tracked part's outputs, static."""
        if "ctrl" not in self._io:
            d = self.device
            self._io["ctrl"] = torch.zeros(_CTRL_LEN, dtype=torch.int64, device=d)
            # ok, n_inliers, n_new_points, is_keyframe, run_map, last_kf
            self._io["front"] = torch.zeros(6, dtype=torch.int32, device=d)
            self._io["front_host"] = torch.zeros(6, dtype=torch.int32, pin_memory=True)
            self._io["front_event"] = torch.cuda.Event()
        return self._io["ctrl"], self._io["front"]

    def _store(self, state: SlamState) -> None:
        """Inside a capture: the step's state into the static buffers."""
        for buf, x in zip(self._state, state):
            if x is not buf:
                buf.copy_(x)

    def _track_program(self, path: str, steer: str | None, frame) -> graph.Program:
        """The tracked part of the step for (path, steering, frame layout):
        ingest, `track_step`; the state and last keyframe go to the static
        buffers, the flags and counts to the static `front` vector."""
        key = ("track", path, steer, self._layout(path, frame))
        if key in self._graphs.programs:
            return self._graphs.programs[key]
        ctrl, front = self._io_buffers()
        src, static, last_kf, cfg = self._static_input(path, frame), self._state, \
            self._last_kf, self._cfg_for(steer)
        mark = None if self.tracer is None else self.tracer.mark

        def run():
            if mark is not None:
                mark("track_start")
            state = self._ingest_step(path, steer, static, ctrl, src)
            if mark is not None:
                mark("front_end")
            t = track_step(state, ctrl[0], last_kf, ctrl[3:5], cfg)
            out = torch.stack([t.ok.to(torch.int32), t.n_inliers.to(torch.int32),
                               t.n_new_points.to(torch.int32), t.is_keyframe.to(torch.int32),
                               t.run_map.to(torch.int32), t.last_kf.to(torch.int32)])
            if graph.capturing():
                self._store(t.state)
                last_kf.copy_(t.last_kf)
                front.copy_(out)
            if mark is not None:
                mark("tracker")
            return front

        return self._graphs.get(key, run)

    def _map_program(self, preds: tuple) -> graph.Program:
        """The mapping block with its parts decided on the host (`preds`, as
        `mapping_predicates` gives them), then detection and the packed
        vector."""
        key = ("map", preds, id(self.loop_closer))
        if key in self._graphs.programs:
            return self._graphs.programs[key]
        ctrl, front = self._io_buffers()
        static, cfg = self._state, self.cfg
        db, voc, lcfg = self._closer_args()
        mark = None if self.tracer is None else self.tracer.mark

        def run():
            i = ctrl[0]
            if mark is not None:
                mark("map_start")
            state, c0, c1, n_f, n_c = mapping_block(static, i, preds, cfg, mark)
            stats = StepStats(tracked=front[0] != 0, n_inliers=front[1], n_new_points=front[2],
                              chi2_before=c0, chi2_after=c1, n_fused=n_f, n_culled=n_c,
                              is_keyframe=front[3] != 0, last_kf=front[5])
            state, _, _, packed = pack_step(
                state, stats, db if graph.capturing() or db is None else db.clone(), i, voc, lcfg)
            if graph.capturing():
                self._store(state)
            if mark is not None:
                mark("detect_pack")
            return packed

        return self._graphs.get(key, run)

    def _tracked(self, path: str, frame, k, timestamp: float, dist, j: int = 0) -> FrameStats:
        i = self._next
        if i >= self.cfg.max_frames:
            raise ValueError(f"frame capacity {self.cfg.max_frames} exhausted")
        tr = self.tracer
        prep = None if tr is None else tr.begin("prep")
        frame, dist = self._host_undistort(path, frame, k, dist)
        steer = None if path == "features" else self._steer
        slot, prev = self._acquire_slot(i)
        row = self._acquire_row()
        try:
            self._ctrl_words(row, i, slot, j, k, dist, prng.split(self._split())[0])
            if path == "image" and not torch.is_tensor(frame):
                frame = row.image(np.asarray(frame))  # staged in the row's pinned buffer
            if self.device.type == "cuda":
                row.counts[0].copy_(launches.counters(self.device), non_blocking=True)
            with torch.inference_mode():
                if self._use_graphs:
                    packed = self._replay(path, steer, frame, row, i, prep)
                else:
                    packed = self._eager(path, steer, frame, row, prep)
        except Exception:
            self._release_slot(slot, prev)
            raise
        row.stats.copy_(packed, non_blocking=True)
        if tr is not None:
            row.stamps.copy_(tr.stamps, non_blocking=True)
        if self.device.type == "cuda":
            row.counts[1].copy_(launches.counters(self.device), non_blocking=True)
        if row.event is not None:
            row.event.record()
        self._next += 1
        self.timestamps.append(float(timestamp))
        st = FrameStats(frame=i)
        st._set_host(row.stats, row.counts, row.event, row.stamps)
        row.owner = st
        self._enqueue(st)
        return st

    def _replay(self, path: str, steer, frame, row: _Row, i: int, prep) -> torch.Tensor:
        """One tracked frame on the card: the tracked part's program, ONE
        host read of its flags (the mapping block's predicates), then the
        matching mapping program. A tracing session ends span `prep` at the
        first launch and spans the launches and the wait."""
        tr = self.tracer
        ctrl, _ = self._io_buffers()
        prog = self._track_program(path, steer, frame)
        ctrl.copy_(row.ctrl, non_blocking=True)
        self._stage(path, frame)
        if tr is not None:
            tr.end(prep)
            span = tr.begin("launch.track")
        front = prog.replay()
        if tr is not None:
            tr.end(span)
        host, ev = self._io["front_host"], self._io["front_event"]
        host.copy_(front, non_blocking=True)
        ev.record()
        if tr is not None:
            span = tr.begin("wait.flags")
        ev.synchronize()
        if tr is not None:
            tr.end(span)
        self.flag_reads += 1
        ok, _, _, is_kf, run_map, _ = (bool(x) for x in host.numpy())
        preds = mapping_predicates(i, ok, is_kf, run_map, self.cfg, self.run_ba)
        prog = self._map_program(tuple(bool(p) for p in preds))
        if tr is None:
            return prog.replay()
        with tr.span("launch.map"):
            return prog.replay()

    def _eager(self, path: str, steer, frame, row: _Row, prep) -> torch.Tensor:
        """The same step run op by op (the CPU, and the card's A/B); a
        tracing session ends span `prep` before it and stamps its parts."""
        ctrl = row.ctrl.to(self.device, copy=True)  # the row is reused
        if path == "image":
            frame = frame.to(self.device)
        mark = None
        if self.tracer is not None:
            self.tracer.end(prep)
            mark = self.tracer.mark
            mark("track_start")
        i, _, _, pnp_key, _, _ = self._unpack_ctrl(ctrl)
        state = self._ingest_step(path, steer, self.state, ctrl, frame)
        if mark is not None:
            mark("front_end")
        state, stats = session_step(state, i, self._last_kf, pnp_key, self._cfg_for(steer),
                                    self.run_ba, mark=mark)
        db, voc, lcfg = self._closer_args()
        state, _, last_kf, packed = pack_step(state, stats, db, i, voc, lcfg)
        if mark is not None:
            mark("detect_pack")
        self.state = state
        self._last_kf = last_kf
        return packed

    def prewarm(self, image: bool = False, n_threads: int = 4, buffer=None,
                image_hw: tuple | None = None) -> float:
        """Pay the one-time costs before frame 0 and return the seconds
        spent: on a card, K1, K2 and K3 are built and loaded (one nvcc each,
        in parallel; a failed build raises), and the programs of a tracked
        frame are captured: the tracked part for features, or with `image`
        for an `image_hw` (default: `cfg.image_wh`) image in each steering
        mode the session can use, or with `buffer` for frames of that device buffer
        (`add_frame_from_buffer`), the mapping programs a keyframe-rate
        session replays, and the untracked frames' ingest and bootstrap
        programs (the reference compiles its step programs and `_bootstrap`
        in its prewarm; the loop closer's programs, relocalization and
        FrameCulling are captured at their first use); on the CPU,
        with `image`, one extraction of a zero image in each mode. With a
        loop closer, the pose graph's edge Jacobians and the Sim3 RANSAC
        polish run on tiny inputs, whose first `torch.func` transforms
        import most of functorch, drawn from their own `PRNGKey(0)` as the
        reference's prewarm does. The session's state, key and counters are
        left as they were (the kernels count the captures' warm-up runs on
        the card: `ops/launches.reset()` after `prewarm` counts frames
        only)."""
        t0 = time.perf_counter()
        dev = self.device
        modes = ("binned", "continuous") if self._auto_steer else (self._steer,)
        H, W = image_hw or self.cfg.image_wh[::-1]
        if dev.type == "cuda":
            with ThreadPoolExecutor(n_threads) as ex:
                for f in [ex.submit(m.load) for m in (fast_score, hamming, small_eigh)]:
                    f.result()
        if self._use_graphs:
            frames = []
            if image:
                zero = torch.zeros((H, W), dtype=torch.float32, device=dev)
                frames += [("image", mode, zero) for mode in modes]
            if buffer is not None:
                frames += [("buffer", mode, buffer) for mode in modes]
            if not image and buffer is None:
                frames.append(("features", None, self._static_input("features", None)))
            ctrl, _ = self._io_buffers()
            for path, mode, frame in frames:
                self._track_program(path, mode, frame)
                fn = self._ingest_fn(path, mode, ctrl, self._static_input(path, frame), False)
                self._graphs.get(("ingest", path, mode, self._layout(path, frame), False),
                                 lambda fn=fn: fn(graph.capturing()))
            boot = self._bootstrap_fn(self._io.words("boot_in", 4).dev,
                                      self._io.readback("boot_out", 3))
            self._graphs.get(("bootstrap", id(self.loop_closer)), lambda: boot(graph.capturing()))
            if self.cfg.ba.keyframe_only:
                for kf, run_map in ((True, True), (False, True), (False, False)):
                    preds = mapping_predicates(0, True, kf, run_map, self.cfg, self.run_ba)
                    self._map_program(tuple(bool(p) for p in preds))
        with torch.inference_mode():
            if image and not self._use_graphs:
                zero = torch.zeros((H, W), dtype=torch.float32, device=dev)
                fe = self.cfg.frontend
                for mode in modes:
                    features_mod.extract(zero, n_features=fe.n_features, n_levels=fe.n_levels,
                                         fast_threshold=fe.fast_threshold, steer_mode=mode)
            if self.loop_closer is not None:
                S = sim3.identity(device=dev)[None].expand(2, 3, 5)
                pose_graph.edge_jacobians(S, S, S)
                k_pts, k_ransac = prng.split(prng.PRNGKey(0))
                Y = prng.uniform_on(k_pts, (8, 3), dev) + torch.tensor([0.0, 0.0, 4.0], device=dev)
                T = torch.eye(4, device=dev)[:3]
                k = torch.tensor([100.0, 100.0, 50.0, 50.0], device=dev)
                uv = cam.project(k, Y)
                alignment.ransac_sim3_reproj(k_ransac, Y, Y, torch.ones(8, dtype=torch.bool, device=dev),
                                             uv, uv, k, k, T, T, n_iters=2)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    # --- lagged host processing: closures, relocalization, FrameCulling ----------
    def _enqueue(self, st: FrameStats) -> None:
        self.stats.append(st)
        self._pending.append(st)
        self._drain(force=False)

    def _drain(self, force: bool) -> None:
        """Process pending frame outcomes once they are `stat_lag` frames old
        (all of them with `force`). A tracing session spans it (`drain`),
        and what it runs carries the frame whose outcome it processes: the
        frame whose processing dispatched FrameCulling, then each stat's."""
        tr = self.tracer
        span = None if tr is None else tr.begin("drain")
        frame = None if tr is None else tr.frame
        lag = self.cfg.stat_lag
        if self._cull_pending is not None and (force or self._next - self._cull_pending[2] > lag):
            if tr is not None:
                tr.frame = self._cull_pending[3]
            self._cull_apply()
        while self._pending and (force or len(self._pending) > lag):
            st = self._pending.pop(0)
            if tr is not None:
                tr.frame = st.frame
            self._process_stat(st)
        if span is not None:
            tr.end(span)
            tr.frame = frame

    def _process_stat(self, st: FrameStats) -> None:
        i = st.frame
        st._resolve()
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
                new, closed = lc.close(self.state, i, j, self._split(),
                                       keyframes=list(self._keyframes))
                self.state = new
            st.loop_closed = closed

    def _try_relocalize(self) -> None:
        """Relocalize the newest ingested frame against the BoW-nearest
        resident keyframes (the failure is seen `stat_lag` frames late; the
        newest frame is the one the next step can chain from). The scores
        program (the reference's `_reloc_scores`) and ONE host read of the
        scores with `slot_of` and `pose_valid`, whose entry for the newest
        frame is its tracked flag (a tracked or relocalized frame, and only
        such a frame, has a valid pose), so its outcome row is not waited
        for; then per candidate the relocalization program (the reference's
        `_reloc`) and ONE host read of its (ok, n_inliers)."""
        lc = self.loop_closer
        i = self._next - 1
        newest = self.stats[i]
        F = self.cfg.max_frames
        words = self._io.words("scores_in", 1).fill([i])
        out = self._io.readback("scores_out", 3 * F)

        def scores_fn(commit: bool):
            st = self.state
            sc = lc.reloc_scores(st, words[0])
            if commit:
                out.dev.copy_(graph.pack([st.slot_of, st.pose_valid], [sc]))

        self._run(("reloc_scores", id(lc)), scores_fn)
        vals = out.start().get()
        slot_of, pose_valid, scores = vals[:F], vals[F:2 * F] != 0, vals[2 * F:].view(np.float32)
        if pose_valid[i]:  # the newest frame was tracked
            self._fail_streak = 0
            return
        if slot_of[i] < 0:
            return
        cands = [int(f) for f in np.argsort(-scores)
                 if np.isfinite(scores[f]) and f < i and slot_of[f] >= 0 and pose_valid[f]]
        rwords, rout = self._io.words("reloc_in", 4), self._io.readback("reloc_out", 2)
        for cand in cands[: self.cfg.track.reloc_candidates]:
            self.reloc_attempts += 1
            rwords.fill([i, cand], self._split())
            self._run(("relocalize",), self._reloc_fn(rwords.dev, rout))
            ok, n = (int(x) for x in rout.start().get())
            if ok:
                self.reloc_successes += 1
                newest.tracked = True
                newest.n_inliers = n
                self._fail_streak = 0
                return

    def _reloc_fn(self, words: torch.Tensor, out: graph.Readback):
        """The relocalization program: frame i against keyframe cand
        (control words i, cand, the key's two words)."""
        cfg = self.cfg

        def fn(commit: bool):
            res = tracker.relocalize(self.state, words[0], words[1], words[2:4], cfg)
            if commit:
                self.state = res.state
                out.dev.copy_(graph.pack([res.ok, res.n_inliers]))

        return fn

    def _cull_dispatch(self) -> None:
        """The FrameCulling program on the current state (the reference's
        `_cull_fn`): one fixed trip over the known keyframes, padded to a
        bucket of the loop closer's `kf_bucket`; its flags come back with ONE
        host read `stat_lag` frames later, as in the reference."""
        m = self.cfg.mapping
        kfs = self._keyframes_known() if self.loop_closer is not None else self.keyframes
        if len(kfs) <= m.kf_keep_recent + 1:
            return
        F = self.cfg.max_frames
        B = self.loop_closer.lc.kf_bucket if self.loop_closer is not None else 128
        Kb = max(B, -(-len(kfs) // B) * B)
        pad = np.zeros(Kb, np.int64)
        pad[: len(kfs)] = kfs
        words = self._io.words(("cull_in", Kb), 1 + Kb).fill([len(kfs)], pad)
        out = self._io.readback("cull_out", F)
        culled = self._io.buffer("culled", self.state.pose_valid)

        def fn(commit: bool):
            kf_pad, n = words[1:], words[0]
            flags = kf_mod.cull_keyframes(self.state, kf_pad, n, m.kf_keep_recent,
                                          redundancy=m.kf_cull_redundancy,
                                          min_other_obs=m.kf_cull_min_other_obs)
            if commit:
                out.dev.copy_(flags.to(torch.int32))
                pos = torch.arange(Kb, device=kf_pad.device)
                culled.copy_(mark(F, kf_pad, keep=pos < n) & ~flags)

        self._run(("cull", Kb), fn)
        self._cull_pending = (out.start(), kfs, self._next,
                              None if self.tracer is None else self.tracer.frame)

    def _cull_apply(self) -> list[int]:
        if self._cull_pending is None:
            return []
        out, kfs, _, _ = self._cull_pending
        self._cull_pending = None
        new_flags = out.get()
        culled = [f for f in kfs if not new_flags[f]]
        self._kf_culled.update(culled)
        if culled and self.loop_closer is not None:
            # culled keyframes leave the candidate set and the floor; their
            # remembered loop edges stay (the pose is still a graph vertex).
            # The rows go with a program of their own (the reference's
            # `_clear_rows`), from the culling program's mask.
            db, mask = self.loop_closer._db, self._io["culled"]

            def clear(commit: bool):
                if commit:
                    db.masked_fill_(mask[:, None], 0.0)

            self._run(("clear_rows", id(self.loop_closer)), clear)
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
    def step_launches(self) -> list[dict]:
        """Each tracked step's kernel launches as the card counted them
        (`FrameStats.launches`; all 0 on the CPU), in frame order."""
        return [st.launches for st in self.stats if st.launches is not None]

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
