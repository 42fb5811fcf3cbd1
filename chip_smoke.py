"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`monocular_slam_tpu_torch`, no JAX) at the
benchmark's full width and checks them:

  1. device   — requires CUDA; prints the card's name and power limit;
  2. build    — compiles K1 (`csrc/fast_score.cu`) and K2
                (`csrc/hamming_top2.cu`) from the checkout, one nvcc each,
                both started together;
  3. K1       — the one-launch kernel vs its plain PyTorch version on the 8
                pyramid levels of a rendered 640x480 frame, and the
                one-level call on 101x173: nms map within 1e-5 everywhere,
                raw map within 1e-5 on the interior (>= 3 px from the
                edge); per frame the median CUDA-event-timed call over 50,
                the kernel's device time from `torch.profiler`, the bound;
  4. extract  — ORB extraction with K1 and with the plain maps: identical
                keypoint sets and descriptors, both steer modes;
  5. session  — the 60-frame 640x480 course rendered on the card through
                `SlamSession.add_frame` with the benchmark's configuration
                (max_frames 64, max_points 20000, 1000 features, 8 levels,
                steer_mode "auto", seed 1, BA on): one warm-up run with the
                tracker's window forced onto the dense route, which also
                counts host syncs, then the measured run, whose window goes
                through K2. Fails below 54/60 tracked, above 3 cm ATE, if
                the two trajectories differ by more than 1e-6 m, below one
                K1 launch per frame, or below 2 K2 launches in any tracked
                frame;
  6. k2       — K2 vs its plain version, equal exactly in d1, d2 and idx, on
                1000x1000 real descriptors (frames 0 and 5 of the course),
                2000x20000 and 2000x65536 random +-1, 97x123, an all-invalid
                32x64, a case with duplicate minima, the tracker's window
                (frame 6 against frames 5..1, 5 x 1000 x 1000 batched), ties
                either side of a split boundary and a batch with ragged
                validity; the kernel route of `match` against the dense
                route, whole `Matches`, on the real pair and the window; per
                shape the median event-timed call over 50, the profiler's
                device time, the bound, and `torch._int_mm` of the same int8
                product alone as a yardstick (the port never calls it);
  7. lc60     — the 60-frame course again with the bench's loop closer
                attached (bundled vocabulary): fps over frames 10-59 and
                ATE; with no closure and no relocalization the ATE must
                equal the session phase's to 1e-4 m;
  8. loop     — a 112-frame course that revisits its start (max_frames 128),
                with 8 frames of uniform noise after frame 40: at least one
                closure with i - j >= 40, at least one relocalization attempt
                that launched K2, tracked >= real frames - 6, ATE <= 10 cm on
                the real frames, then a direct `tracker.relocalize` of the
                last frame against its predecessor;
  9. scale    — the matrix-free solvers at benchmarks/kitti_scale.py's shapes
                (numpy draws): a 10,000-keyframe drifted Sim3 graph with 100
                loop edges through `pose_graph.optimize_cg` and the 1000-
                camera, 100,000-point, 1.5M-edge problem through
                `cg_ba.bundle_adjust_cg` (10 LM iterations each, the second
                of two calls timed): finite, chi2 down at least 10x, the BA
                under twice its statistical floor 2 sigma^2 E; seconds per LM
                iteration and peak device memory. Then both routes of global
                BA and of `correct` on the loop phase's final state: the
                CG route's poses (99% of its points) must agree with the
                dense route's to within 10% (25%) of the dense correction;
 10. dist     — the distributed solvers (`parallel/*`). NCCL at world size 1
                in this process: `distributed_bundle_adjust(solver="cg")` on
                the scale phase's 1.5M-edge problem against
                `cg_ba.bundle_adjust_cg` (50 PCG steps), `distributed_optimize`
                on its 10,000-keyframe graph against `optimize_cg`, and
                `solver="dense"` on the loop phase's global-BA problem against
                `ba.bundle_adjust`: chi2 histories to rtol 1e-5 and poses to
                1e-5; seconds per LM iteration of each route, the all-reduce
                calls and bytes per PCG step (counted by
                `distributed.record_collectives`: one (F, 6) sum per step plus
                one per LM iteration, none above 100 F elements but the final
                gather), NCCL's share in `torch.profiler`. Then two gloo ranks
                as processes on the same card, `initialize`d from the MSLAM_*
                variables (`chip_smoke.py dist-rank`): a seeded problem of
                128 cameras, 20,000 points and 1000 observations per camera
                through "auto" (dense at 2 shards) and "cg" (finite, chi2
                down, within DIST_GLOO_TOL of the single-device routes) and
                the golden fixture (poses within 1e-5 of ba_expected.npz).
                Repeat check: the CG BA (single-device and sharded), the CG
                pose graph and the 60-frame session each run twice, bit for
                bit the same;
 11. long     — benchmarks/long_run.py's configuration (`run_long`) cut to
                LONG_FRAMES frames, with the pose graph's dense/CG switch
                at the reference's 128 keyframes (the port's default, 512,
                is past this run): fails on a non-finite pose, below 95%
                tracked, below 2 closures, if `optimize_cg` or
                `bundle_adjust_cg` was never called, if no feature slot was
                evicted, unless K1 launched once per frame and K2 at least
                twice in every track call; reports ATE, fps, prewarm
                seconds, each Sim3's seconds and the closure stages;
 12. cli      — the port's CLI as a user runs it: the long run's course
                (seed 19, 0.05 rad/frame) rendered on the card for
                CLI_FRAMES frames, written as a TUM directory by
                `render.write_tum` (8-bit PNGs, groundtruth, calib) and
                decoded back by `tum.load(...).load_images_batch` (must equal
                the rendered uint8 frames bit for bit); then `python -m
                monocular_slam_tpu_torch.run --dataset <dir> --loop-closure
                --vocab default --verbose` as a subprocess at the CLI's
                default width (1000 features, max_frames 256, max_points
                30000): exit code 0, tracked >= 95%, ATE <= 5 cm, a
                closure with i - j >= 40, the summary's ATE equal to
                `eval.compare` of trajectory.txt
                against groundtruth.txt to 1e-5 m, map.ply readable, K1 one
                launch per frame and K2 at least twice per track call
                (the CLI's own counts). Then the first KITTI_FRAMES frames
                in KITTI layout through `run.main` in-process (tracked >=
                KITTI_MIN_TRACKED) and the synthetic feature route at the
                CLI's defaults (finite ATE).
 13. mesh     — `viz.mesh.estimate_normals` + `poisson_mesh` on the card:
                the cli phase's map.ply points (finite, triangles) and the
                4000-point unit sphere at depth 5 (watertight: no boundary
                edge; mean radius within 5% of 1); seconds of each.

Every phase raises on failure. Kernel launch counts are set to 0 just
before each path is driven and read just after (in `long`, after the
prewarm; in `cli`, the CLI subprocess counts its main loop); the kernels
JSON reports the session's measured run under `launches` and the CLI's
under `launches_cli`. The second-to-last line is
the kernels JSON, the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

K1_SOURCE = "monocular_slam_tpu_torch/csrc/fast_score.cu"
K1_REPLACES = "monocular_slam_tpu/ops/pallas/fast_score.py:105"
K2_SOURCE = "monocular_slam_tpu_torch/csrc/hamming_top2.cu"
K2_REPLACES = "monocular_slam_tpu/ops/pallas/hamming.py:77"
TOL = 1e-5
N_FRAMES = 60
WH = (640, 480)
MIN_TRACKED = 54
MAX_ATE_M = 0.03
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
K1_OPS_PER_PX = 160  # 16 ring differences, the two circular min-9 passes, NMS
TRAJ_TOL_M = 1e-6  # dense-window vs K2-window session trajectories
LOOP_FRAMES = 112
BLACKOUT_AFTER = 40
BLACKOUT = 8
LOOP_MAX_ATE_M = 0.10
# benchmarks/kitti_scale.py's shapes; benchmarks/long_run.py's course, cut
# from 1000 frames to LONG_FRAMES (a closure past 128 keyframes included)
SCALE_KF = 10_000
SCALE_LOOPS = 100
SCALE_BA = (1000, 100_000, 1500)  # cameras, points, observations per camera
SCALE_ITERS = 10
CG_VS_DENSE_FRAC = (0.1, 0.25)  # CG vs dense route on the loop state: poses, 99% of points
# the dist phase: sharded routes at world size 1 (NCCL) against the single-
# device routes; two gloo ranks on a seeded problem of DIST_BA's shape
DIST_RTOL = 1e-5
DIST_POSE_TOL = 1e-5
DIST_BA = (128, 20_000, 1000)  # cameras, points, observations per camera
DIST_GLOO_TOL = {"auto": (1e-5, 1e-4), "cg": (1e-5, 1e-4)}  # (chi2 final rel, pose) vs single
DIST_RANK_TIMEOUT_S = 300
LONG_FRAMES = 400
# the CLI phase: the long run's orbit through files, the decoder and the CLI
CLI_FRAMES = 200
CLI_MIN_TRACKED = 190
CLI_MAX_ATE_M = 0.05
CLI_TIMEOUT_S = 480
KITTI_FRAMES = 40
KITTI_MIN_TRACKED = 38
ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, n: int = 50) -> float:
    """Median of n CUDA-event-timed calls (after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms_inference(fn, n: int = 50) -> float:
    """`time_ms` inside `torch.inference_mode()`, as the session calls the
    kernels (views and outputs then carry no autograd metadata)."""
    with torch.inference_mode():
        return time_ms(fn, n)


def device_ms(fn, kernel: str, n: int = 20):
    """The kernel's mean device time per launch (ms) from `torch.profiler`
    over n calls of fn, matched by kernel name; None if the profiler saw
    no launch of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total_us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            count += e.count
    return total_us / count / 1e3 if count else None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # name and power limit, as nvidia-smi prints them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def phase_build():
    from monocular_slam_tpu_torch.ops import fast_score, hamming

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # one nvcc per source, started together
        for f in [ex.submit(fast_score.load), ex.submit(hamming.load)]:
            f.result()
    log(f"[build] K1 and K2 built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, mod in (("K1", fast_score), ("K2", hamming)):
        log(f"[build] {name} {mod.BUILD_INFO['path']} "
            f"(nvcc {mod.BUILD_INFO.get('seconds', 0.0):.2f} s)")
        for line in mod.BUILD_INFO.get("log", "").splitlines():
            log(f"[build]   {line}")


def _k1_check(name, img, nms_k, raw_k, nms_p, raw_p) -> float:
    e_nms = (nms_k - nms_p).abs().max().item()
    e_raw = (raw_k - raw_p)[3:-3, 3:-3].abs().max().item()
    n_corners = int((nms_p > 0).sum())
    if not (e_nms <= TOL and e_raw <= TOL):
        raise AssertionError(f"K1 disagrees at {name} {tuple(img.shape)}: nms {e_nms} raw {e_raw}")
    if n_corners == 0:
        raise AssertionError(f"no corners at {name} {tuple(img.shape)}: the check is vacuous")
    log(f"[k1] {name} {tuple(img.shape)}: corners {n_corners}, max|dnms| {e_nms:.3g}, "
        f"max|draw| interior {e_raw:.3g}")
    return max(e_nms, e_raw)


def phase_k1(frame: torch.Tensor) -> dict:
    """K1 vs plain: all 8 pyramid levels of `frame` in one launch, and the
    one-level call on 101x173."""
    from monocular_slam_tpu_torch.ops import fast_score, pyramid

    levels = [x.contiguous() for x in pyramid.build_pyramid(frame.contiguous())]
    g = torch.Generator(device=frame.device).manual_seed(9)
    odd = 40.0 * torch.rand((101, 173), generator=g, device=frame.device)
    odd[20:40, 30:50] += 120.0
    odd[60:63, 100:140] += 90.0

    before = fast_score.LAUNCHES
    maps_k = fast_score.corner_maps_levels(levels, 20.0)
    torch.cuda.synchronize()
    if fast_score.LAUNCHES != before + 1:
        raise AssertionError("K1: all levels did not go in one launch")
    maps_p = fast_score.corner_maps_levels_plain(levels, 20.0)
    worst = 0.0
    for lvl, (img, mk, mp) in enumerate(zip(levels, maps_k, maps_p)):
        worst = max(worst, _k1_check(f"level {lvl}", img, *mk, *mp))
    worst = max(worst, _k1_check("one-level call", odd, *fast_score.corner_maps(odd, 20.0),
                                 *fast_score.corner_maps_plain(odd, 20.0)))

    k_ms = time_ms(lambda: fast_score.corner_maps_levels(levels, 20.0))
    k_inf = time_ms_inference(lambda: fast_score.corner_maps_levels(levels, 20.0))
    p_ms = time_ms(lambda: fast_score.corner_maps_levels_plain(levels, 20.0))
    d_ms = device_ms(lambda: fast_score.corner_maps_levels(levels, 20.0),
                     "corner_maps_levels_kernel")
    odd_ms = time_ms(lambda: fast_score.corner_maps(odd, 20.0))
    odd_dev = device_ms(lambda: fast_score.corner_maps(odd, 20.0), "corner_maps_levels_kernel")
    px = sum(int(x.numel()) for x in levels)
    t_bytes, t_ops = 12.0 * px / HBM_BYTES_PER_S, K1_OPS_PER_PX * px / F32_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    log(f"[k1] per frame (8 levels, 1 launch): call {k_ms:.4f} ms ({k_inf:.4f} ms in inference "
        f"mode), device {_fmt(d_ms)}, "
        f"plain {p_ms:.4f} ms, bound {bound:.5f} ms ({px} px: 12 B/px over HBM "
        f"{t_bytes * 1e3:.5f} ms, {K1_OPS_PER_PX} f32 ops/px {t_ops * 1e3:.5f} ms), "
        f"share of bound {bound / k_ms:.4f} of the call"
        + ("" if d_ms is None else f", {bound / d_ms:.4f} of the device time"))
    log(f"[k1] one-level call 101x173: call {odd_ms:.4f} ms, device {_fmt(odd_dev)}")
    return {"max_abs_err": worst, "ms": k_ms, "ms_inference": k_inf, "plain_ms": p_ms,
            "device_ms": d_ms,
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_extract(frame: torch.Tensor) -> None:
    from monocular_slam_tpu_torch.ops import fast_score, features

    for mode in ("binned", "continuous"):
        fk = features.extract(frame, n_features=1000, steer_mode=mode)
        fp = features.extract(frame, n_features=1000, steer_mode=mode,
                              levels_maps_fn=fast_score.corner_maps_levels_plain)
        vk, vp = fk.valid.cpu().numpy(), fp.valid.cpu().numpy()
        sk = {tuple(r) for r in np.round(fk.uv.cpu().numpy()[vk], 4)}
        sp = {tuple(r) for r in np.round(fp.uv.cpu().numpy()[vp], 4)}
        same_desc = bool((fk.desc == fp.desc).all())
        if sk != sp or not same_desc:
            raise AssertionError(f"extract({mode}): K1 and plain keypoints differ")
        log(f"[extract] {mode}: {int(vk.sum())} valid keypoints, identical sets and descriptors")


def run_session(imgs, poses_gt, k, count_syncs: bool, loop_closer: bool = False,
                dense_window: bool = False):
    """One session over `imgs`. `dense_window` forces the tracker's window
    onto the dense route; every `tracker.track` call's K2 launches are
    recorded."""
    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.ops import hamming
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    cfg = SlamConfig(max_frames=64, max_points=20000, image_wh=WH,
                     frontend=FrontendConfig(n_features=1000))
    lc = LoopCloser(vocabulary.load_default(), cfg) if loop_closer else None
    sess = SlamSession(cfg, seed=1, run_ba=True, loop_closer=lc, device="cuda")
    skip = 10
    syncs = 0
    sync_src: dict[str, int] = {}
    t_tail = 0.0
    plain_track, plain_window = tracker.track, tracker._window_matches
    track_k2 = []  # K2 launches inside each tracker.track call

    def counted_track(*a, **kw):
        before = hamming.LAUNCHES
        res = plain_track(*a, **kw)
        track_k2.append(hamming.LAUNCHES - before)
        return res

    tracker.track = counted_track
    if dense_window:
        tracker._window_matches = functools.partial(plain_window, use_kernel=False)
    try:
        for i in range(len(imgs)):
            if i == skip:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if count_syncs and i >= skip:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    sess.add_frame(imgs[i], k, i / 30.0)
                    torch.cuda.set_sync_debug_mode("default")
                for x in w:
                    if "synchroniz" in str(x.message):
                        syncs += 1
                        src = f"{x.filename.split('monocular_slam_tpu_torch/')[-1]}:{x.lineno}"
                        sync_src[src] = sync_src.get(src, 0) + 1
            else:
                sess.add_frame(imgs[i], k, i / 30.0)
        torch.cuda.synchronize()
        t_tail = time.perf_counter() - t0
    finally:
        tracker.track, tracker._window_matches = plain_track, plain_window
    poses, valid, _ = sess.trajectory()
    if not np.isfinite(poses[valid]).all():
        raise AssertionError("non-finite poses")
    r = ate_mod.ate(poses[valid], poses_gt[valid])
    out = {} if lc is None else {
        "closures": len(lc.closures), "reloc_attempts": sess.reloc_attempts,
        "culled_keyframes": len(sess._kf_culled),
    }
    return out | {
        "tracked": int(valid.sum()), "ate_m": r.rmse,
        "fps_10_59": (len(imgs) - skip) / t_tail,
        "syncs_per_frame": syncs / (len(imgs) - skip) if count_syncs else None,
        "sync_sources": dict(sorted(sync_src.items(), key=lambda kv: -kv[1])[:10]),
        "n_map_points": sess.n_map_points,
        "keyframes": len(sess.keyframes),
        "track_calls": len(track_k2), "k2_per_track_min": min(track_k2, default=0),
        "poses": poses, "valid": valid,
    }


def phase_session() -> dict:
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import fast_score, hamming

    t0 = time.perf_counter()
    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=N_FRAMES, wh=WH, device="cuda")
    torch.cuda.synchronize()
    log(f"[session] rendered {N_FRAMES} frames {WH[0]}x{WH[1]} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    phase_k1_out = phase_k1(imgs[0])
    phase_extract(imgs[0])

    warm = run_session(imgs, poses_gt, k, count_syncs=True, dense_window=True)
    log(f"[session] warm-up run (dense window route): tracked {warm['tracked']}/{N_FRAMES}, "
        f"ATE {warm['ate_m'] * 100:.3f} cm, host syncs/frame (frames 10-59) "
        f"{warm['syncs_per_frame']:.2f}, K2 launches per track call {warm['k2_per_track_min']}")
    log("[session] host syncs by source over frames 10-59: " + json.dumps(warm["sync_sources"]))

    fast_score.LAUNCHES = hamming.LAUNCHES = 0
    out = run_session(imgs, poses_gt, k, count_syncs=False)
    k1_launches, k2_launches = fast_score.LAUNCHES, hamming.LAUNCHES
    same_valid = bool((out["valid"] == warm["valid"]).all())
    v = out["valid"] & warm["valid"]
    traj_diff = float(np.abs(out["poses"][v] - warm["poses"][v]).max()) if v.any() else float("inf")
    poses = out.pop("poses")
    del out["valid"], warm["poses"], warm["valid"], out["sync_sources"]
    out["syncs_per_frame"] = warm["syncs_per_frame"]
    out["fps_10_59_dense_window"] = warm["fps_10_59"]
    out["k1_launches"], out["k2_launches"] = k1_launches, k2_launches
    out["max_pose_diff_vs_dense_window"] = traj_diff
    log("[session] " + json.dumps(out))
    log(f"[session] tracked {out['tracked']}/{N_FRAMES}, ATE {out['ate_m'] * 100:.3f} cm, "
        f"{out['fps_10_59']:.2f} fps over frames 10-59 (dense window {warm['fps_10_59']:.2f}), "
        f"K1 launches {k1_launches}, K2 launches {k2_launches} in {out['track_calls']} track "
        f"calls (at least {out['k2_per_track_min']} each), max |pose - dense-window pose| "
        f"{traj_diff:.3g}")
    if out["tracked"] < MIN_TRACKED:
        raise AssertionError(f"tracked {out['tracked']} < {MIN_TRACKED}")
    if not out["ate_m"] <= MAX_ATE_M:
        raise AssertionError(f"ATE {out['ate_m']} m > {MAX_ATE_M} m")
    if not same_valid or not traj_diff <= TRAJ_TOL_M:
        raise AssertionError(f"K2 window run differs from the dense-window run: valid equal "
                             f"{same_valid}, max pose difference {traj_diff}")
    if k1_launches < N_FRAMES:
        raise AssertionError(f"K1 launched {k1_launches} times, < 1 per frame")
    if out["track_calls"] < MIN_TRACKED - 2 or out["k2_per_track_min"] < 2:
        raise AssertionError(f"K2: {out['track_calls']} track calls, at least "
                             f"{out['k2_per_track_min']} launches each (want >= 2)")
    return {"k1": phase_k1_out, "k1_launches": k1_launches, "k2_launches": k2_launches,
            "imgs": imgs, "poses_gt": poses_gt, "k": k, "ate_m": out["ate_m"], "poses": poses}


WINDOW = "window 5x1000x1000, frame 6 vs frames 5..1"


def _k2_cases(imgs):
    """(name, a, b, b_valid, a_valid or None) on the card: the main path's
    1000x1000 pair of real descriptors, the map-scale shapes of
    benchmarks/loop_match_scale.py, an odd shape, an all-invalid database,
    duplicate minima, the tracker's window (real descriptors), ties either
    side of a split boundary, and a batch with ragged validity."""
    from monocular_slam_tpu_torch.ops import features

    dev = imgs.device
    g = torch.Generator(device=dev).manual_seed(21)

    def pm1(*shape):
        return torch.randint(0, 2, (*shape, 256), generator=g, device=dev, dtype=torch.int8) * 2 - 1

    f = [features.extract(imgs[i], n_features=1000) for i in range(7)]
    cases = [("1000x1000 frames 0/5", f[0].desc_pm1.contiguous(), f[5].desc_pm1.contiguous(),
              f[5].valid.contiguous(), f[0].valid.contiguous())]
    for n, m in ((2000, 20000), (2000, 65536), (97, 123)):
        bv = torch.rand(m, generator=g, device=dev) > 0.05
        cases.append((f"{n}x{m}", pm1(n), pm1(m), bv, None))
    cases.append(("32x64 all invalid", pm1(32), pm1(64), torch.zeros(64, dtype=torch.bool, device=dev), None))
    a = pm1(40)
    b = torch.cat([pm1(30), a[:20], a[:20], pm1(10)])
    cases.append(("40x80 duplicate minima", a, b.contiguous(), torch.ones(80, dtype=torch.bool, device=dev), None))
    win = [f[j] for j in (5, 4, 3, 2, 1)]
    cases.append((WINDOW, f[6].desc_pm1.contiguous(),
                  torch.stack([x.desc_pm1 for x in win]).contiguous(),
                  torch.stack([x.valid for x in win]).contiguous(), f[6].valid.contiguous()))
    a = pm1(64)
    b = pm1(256)
    b[127] = b[128] = a[0]  # the split boundary of this shape is row 128
    b[100:127] = a[1:28]
    b[129:156] = a[1:28]
    cases.append(("64x256 ties across the split", a, b, torch.ones(256, dtype=torch.bool, device=dev), None))
    a = pm1(300)
    b = pm1(3, 1000)
    b[0, 900:1000] = a[:100]
    bv = torch.rand(3, 1000, generator=g, device=dev) > torch.tensor([0.05, 0.6, 1.0], device=dev)[:, None]
    cases.append(("300 x 3x1000 ragged validity", a, b, bv.contiguous(), None))
    return cases


def _int_mm_ms(a, b):
    """`torch._int_mm` of the same int8 product alone (a yardstick), or None
    where its shape rules (N > 16, M % 8 == 0) refuse the shape."""
    b2 = b.reshape(-1, 256)
    if a.shape[0] <= 16 or b2.shape[0] % 8:
        return None
    bt = b2.t()
    return time_ms(lambda: torch._int_mm(a, bt))


def phase_k2(imgs) -> dict:
    from monocular_slam_tpu_torch.ops import hamming, matching

    out = {}
    for name, a, b, bv, av in _k2_cases(imgs):
        k = hamming.hamming_top2_cuda(a, b, bv)
        torch.cuda.synchronize()
        p = hamming.hamming_top2_plain(a, b, bv)
        torch.cuda.synchronize()
        eq = [bool(torch.equal(x, y)) for x, y in zip(k, p)]
        err = max(int((x - y).abs().max()) for x, y in zip(k, p))
        if not all(eq):
            raise AssertionError(f"K2 disagrees with its plain version at {name}: d1/d2/idx equal {eq}")
        N, M = a.shape[0], b.shape[-2]
        B = b.shape[0] if b.dim() == 3 else 1
        S = hamming.splits(N, M, B, torch.cuda.get_device_properties(a.device).multi_processor_count)
        km = time_ms(lambda: hamming.hamming_top2_cuda(a, b, bv))
        ki = time_ms_inference(lambda: hamming.hamming_top2_cuda(a, b, bv))
        dm = device_ms(lambda: hamming.hamming_top2_cuda(a, b, bv), "hamming_top2_kernel")
        pm = time_ms(lambda: hamming.hamming_top2_plain(a, b, bv))
        im = _int_mm_ms(a, b)
        t_bytes = (N * 256 + B * M * 257 + 3 * B * N * 4) / HBM_BYTES_PER_S
        t_ops = 2.0 * N * B * M * 256 / INT8_OPS_PER_S
        row = {"ms": km, "ms_inference": ki, "device_ms": dm, "plain_ms": pm, "int_mm_ms": im,
               "bound_ms": max(t_bytes, t_ops) * 1e3, "splits": S,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "max_abs_err": err}
        msg = (f"[k2] {name} (B={B}, S={S}): d1/d2/idx equal, K2 call {km:.4f} ms "
               f"({ki:.4f} ms in inference mode), device "
               f"{_fmt(dm)}, plain (dense f32 matmul + min/argmin) {pm:.4f} ms, bound "
               f"{row['bound_ms']:.5f} ms ({row['bound_by']}), torch._int_mm of the product "
               f"{_fmt(im)}")
        if av is not None:
            mk = matching.match(a, b, av, bv, use_kernel=True)
            md = matching.match(a, b, av, bv, use_kernel=False)
            for fld in ("idx", "dist", "ok", "n_matches"):
                if not torch.equal(getattr(mk, fld), getattr(md, fld)):
                    raise AssertionError(f"match kernel route != dense route in {fld} at {name}")
            row["match_kernel_ms"] = time_ms(lambda: matching.match(a, b, av, bv, use_kernel=True))
            row["match_dense_ms"] = time_ms(lambda: matching.match(a, b, av, bv, use_kernel=False))
            msg += (f"; match: {mk.n_matches.tolist()} matches, kernel route (2 launches) "
                    f"{row['match_kernel_ms']:.4f} ms, dense route {row['match_dense_ms']:.4f} ms, "
                    f"whole Matches equal")
        log(msg)
        out[name] = row
    return out


def phase_lc60(sess_out) -> dict:
    """The bench's second configuration: the same course with the loop
    closer attached; K2 counted from 0 over the run."""
    from monocular_slam_tpu_torch.ops import fast_score, hamming

    fast_score.LAUNCHES = hamming.LAUNCHES = 0
    out = run_session(sess_out["imgs"], sess_out["poses_gt"], sess_out["k"], count_syncs=False,
                      loop_closer=True)
    out["k1_launches"], out["k2_launches"] = fast_score.LAUNCHES, hamming.LAUNCHES
    del out["sync_sources"], out["poses"], out["valid"]
    log("[lc60] " + json.dumps(out))
    log(f"[lc60] tracked {out['tracked']}/{N_FRAMES}, ATE {out['ate_m'] * 100:.3f} cm "
        f"(without the closer {sess_out['ate_m'] * 100:.3f} cm), {out['fps_10_59']:.2f} fps over "
        f"frames 10-59, closures {out['closures']}, relocalization attempts {out['reloc_attempts']}")
    if out["tracked"] < MIN_TRACKED or not out["ate_m"] <= MAX_ATE_M:
        raise AssertionError(f"lc60: tracked {out['tracked']}, ATE {out['ate_m']}")
    if out["k1_launches"] < N_FRAMES:
        raise AssertionError(f"lc60: K1 launched {out['k1_launches']} times, < 1 per frame")
    if out["closures"] == 0 and out["reloc_attempts"] == 0:
        if abs(out["ate_m"] - sess_out["ate_m"]) > 1e-4:
            raise AssertionError(f"lc60: nothing fired but ATE {out['ate_m']} != {sess_out['ate_m']}")
    return out


def _loop_frames(dev):
    """The revisiting course with a blackout: real frames 0..40, 8 frames of
    uniform noise, then real frames 41..111. Returns (frames, real_ids)."""
    from monocular_slam_tpu_torch.datasets import render

    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=LOOP_FRAMES, wh=WH,
                                               ang_step=0.06, device=dev)
    g = torch.Generator(device=dev).manual_seed(40)
    noise = torch.floor(255.0 * torch.rand((BLACKOUT, WH[1], WH[0]), generator=g, device=dev))
    cut = BLACKOUT_AFTER + 1
    frames = torch.cat([imgs[:cut], noise, imgs[cut:]])
    real = list(range(cut)) + list(range(cut + BLACKOUT, LOOP_FRAMES + BLACKOUT))
    return frames, real, poses_gt, k


def run_loop(frames, real, poses_gt, k, voc, label: str) -> dict:
    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    dev = frames.device
    cfg = SlamConfig(max_frames=128, max_points=20000, image_wh=WH,
                     frontend=FrontendConfig(n_features=1000))
    lc = LoopCloser(voc, cfg, device=dev)
    sess = SlamSession(cfg, seed=1, run_ba=True, loop_closer=lc, device=dev)
    reloc_k2 = []  # K2 launches inside each relocalization attempt
    plain_reloc = tracker.relocalize

    def counted_reloc(*a, **kw):
        before = hamming.LAUNCHES
        res = plain_reloc(*a, **kw)
        reloc_k2.append(hamming.LAUNCHES - before)
        return res

    tracker.relocalize = counted_reloc
    fast_score.LAUNCHES = hamming.LAUNCHES = 0
    try:
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(frames.shape[0]):
            sess.add_frame(frames[i], k, i / 30.0)
        sess.flush()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        tracker.relocalize = plain_reloc
    launches, k1_launches = hamming.LAUNCHES, fast_score.LAUNCHES
    poses, valid, _ = sess.trajectory()
    rv = valid[real]
    r = ate_mod.ate(poses[real][rv], poses_gt[rv])
    out = {
        "vocabulary": label, "frames": int(frames.shape[0]), "real_frames": len(real),
        "tracked_real": int(rv.sum()), "tracked_noise": int(valid.sum() - rv.sum()),
        "ate_m": r.rmse, "fps": frames.shape[0] / wall, "closures": lc.closures,
        "corrected": lc.corrected, "skipped_identity": lc.skipped_identity,
        "reverted": lc.reverted, "culled_keyframes": sorted(sess._kf_culled),
        "keyframes": len(sess.keyframes), "reloc_attempts": sess.reloc_attempts,
        "reloc_successes": sess.reloc_successes, "k2_in_reloc": reloc_k2,
        "k1_launches": k1_launches, "k2_launches": launches, "timings_s": lc.timings,
    }
    return out, sess


def phase_loop(dev="cuda") -> dict:
    from monocular_slam_tpu_torch.ops import features
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam import tracker

    t0 = time.perf_counter()
    frames, real, poses_gt, k = _loop_frames(torch.device(dev))
    log(f"[loop] rendered {LOOP_FRAMES} frames + {BLACKOUT} noise frames in "
        f"{time.perf_counter() - t0:.2f} s")
    out, sess = run_loop(frames, real, poses_gt, k, vocabulary.load_default(dev), "bundled")
    log("[loop] " + json.dumps(out))
    if not any(i - j >= 40 for i, j in out["closures"]):
        # the reference's e2e test trains on the course itself (k=8, L=4)
        descs = []
        for i in real[::2]:
            f = features.extract(frames[i], n_features=1000)
            descs.append(f.desc_pm1[f.valid].cpu().numpy())
        voc = vocabulary.train(np.concatenate(descs), k=8, L=4, seed=0, device=dev)
        out, sess = run_loop(frames, real, poses_gt, k, voc, "trained k=8 L=4 on the course")
        log("[loop] no closure with the bundled vocabulary; retrained: " + json.dumps(out))
    if not any(i - j >= 40 for i, j in out["closures"]):
        raise AssertionError(f"loop: no closure with i - j >= 40: {out['closures']}")
    if out["reloc_attempts"] < 1 or not any(n > 0 for n in out["k2_in_reloc"]):
        raise AssertionError(f"loop: no relocalization attempt that launched K2: {out['k2_in_reloc']}")
    if out["tracked_real"] < len(real) - 6:
        raise AssertionError(f"loop: tracked {out['tracked_real']} of {len(real)} real frames")
    if not out["ate_m"] <= LOOP_MAX_ATE_M:
        raise AssertionError(f"loop: ATE {out['ate_m']} m > {LOOP_MAX_ATE_M} m")
    if out["k1_launches"] < out["frames"]:
        raise AssertionError(f"loop: K1 launched {out['k1_launches']} times, < 1 per frame")
    last = frames.shape[0] - 1
    with torch.inference_mode():
        res = tracker.relocalize(sess.state, last, last - 1, sess.gen, sess.cfg)
    ok, n = bool(res.ok), int(res.n_inliers)
    log(f"[loop] closures {out['closures']}, corrected {out['corrected']}, skipped-identity "
        f"{out['skipped_identity']}, culled keyframes {len(out['culled_keyframes'])}, "
        f"relocalization {out['reloc_successes']}/{out['reloc_attempts']} attempts succeeded, "
        f"K2 launches {out['k2_launches']}, tracked {out['tracked_real']}/{len(real)} real frames, "
        f"ATE {out['ate_m'] * 100:.3f} cm, {out['fps']:.2f} fps; direct relocalize of frame "
        f"{last} against {last - 1}: ok {ok}, {n} inliers")
    if not ok or n < sess.cfg.track.reloc_min_inliers:
        raise AssertionError(f"loop: direct relocalize failed ({ok}, {n} inliers)")
    return out, sess


def _scale_pose_graph(dev):
    """benchmarks/kitti_scale.py's pose graph with numpy draws: SCALE_KF Sim3
    keyframes on four revolutions of a 50 m circle, drifted by accumulated
    0.01-sigma tangent noise, odometry edges plus loop edges i -> i - n/4
    (one revolution) measured from the truth."""
    from monocular_slam_tpu_torch.geometry import sim3, so3
    from monocular_slam_tpu_torch.optim import pose_graph

    n = SCALE_KF
    ang = np.arange(n) * (2 * np.pi / (n / 4))
    t = np.stack([np.sin(ang) * 50, np.zeros(n), np.cos(ang) * 50], -1)
    rot = np.stack([np.zeros(n), ang, np.zeros(n)], -1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    verts = sim3.pack(so3.exp(f32(rot)), f32(t), torch.ones(n, device=dev))
    step = 0.01 * np.random.RandomState(0).randn(n, 7)
    step[0] = 0.0
    verts_n = sim3.compose(sim3.exp(f32(np.cumsum(step, 0))), verts)
    li = np.arange(n // 4, n, max(1, n // SCALE_LOOPS))
    lj = li - n // 4
    meas = sim3.compose(verts[li], sim3.inverse(verts[lj]))
    return pose_graph.sequential_graph(verts_n, torch.ones(n, dtype=torch.bool, device=dev),
                                       li, lj, meas)


def _scale_ba_problem(dev):
    """benchmarks/kitti_scale.py's global BA with numpy draws: SCALE_BA[0]
    cameras on an 80 m circle looking at SCALE_BA[1] points in a 30 m ball
    (KITTI cam0 intrinsics), SCALE_BA[2] observations per camera of random
    points with 0.5 px noise, poses perturbed by 0.005-sigma twists, points
    by 0.1 m; camera 0 fixed. Returns (BAProblem, statistical chi2 floor
    2 sigma^2 E)."""
    from monocular_slam_tpu_torch.geometry import se3
    from monocular_slam_tpu_torch.optim import ba

    F, P, obs = SCALE_BA
    rng = np.random.RandomState(1)
    d = rng.randn(P, 3)
    X = 30.0 * d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(size=(P, 1)) ** (1 / 3)
    k = np.array([718.856, 718.856, 607.19, 185.22])
    ang = np.arange(F) * (2 * np.pi / F)
    c = np.stack([80.0 * np.sin(ang), np.zeros(F), -80.0 * np.cos(ang)], -1)
    z = -c / np.linalg.norm(c, axis=1, keepdims=True)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], 1)  # rows: the camera axes in the world
    poses = np.concatenate([R, -(R @ c[:, :, None])], 2)
    E = F * obs
    cam_idx = np.repeat(np.arange(F), obs)
    pt_idx = rng.randint(0, P, E)
    Xc = np.einsum("eij,ej->ei", R[cam_idx], X[pt_idx]) + poses[cam_idx, :, 3]
    uv = k[:2] * Xc[:, :2] / Xc[:, 2:] + k[2:] + 0.5 * rng.randn(E, 2)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    fixed = np.zeros(F, bool)
    fixed[0] = True
    prob = ba.BAProblem(
        poses=se3.compose(se3.exp(f32(0.005 * rng.randn(F, 6))), f32(poses)),
        points=f32(X + 0.1 * rng.randn(P, 3)), k=f32(np.tile(k, (F, 1))),
        cam_idx=torch.as_tensor(cam_idx, device=dev), pt_idx=torch.as_tensor(pt_idx, device=dev),
        uv=f32(uv), info=torch.ones(E, device=dev), valid=torch.ones(E, dtype=torch.bool, device=dev),
        fixed=torch.as_tensor(fixed, device=dev),
    )
    return prob, 2.0 * 0.5**2 * E


def _timed_solve(fn):
    """(result, seconds, peak device memory in MB) of one synchronized call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**20


def device_ops(fn, summarized: bool = False):
    """Operations (kernels, copies, memsets) one call of fn puts on the card,
    counted by `torch.profiler` from its raw device events (building its
    per-event summaries took minutes for the 10^6 operations of a CG
    correction). With `summarized`, (raw count, the count summed over
    `key_averages()`), to show that the two counters agree."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    raw = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)
    if not summarized:
        return raw
    return raw, sum(e.count for e in prof.key_averages() if e.device_type == cuda)


def _state_diff(a, b, ref) -> dict:
    """Differences between two states over the valid frames and points of
    `ref` (m): the largest pose entry, and the largest, 99th-percentile and
    median point distance."""
    v, pv = ref.pose_valid, ref.point_valid
    d = torch.linalg.norm(a.points - b.points, dim=-1)[pv]
    q = torch.quantile(d, torch.tensor([0.5, 0.99], device=d.device)).tolist()
    return {"max_pose_diff_m": (a.poses - b.poses)[v].abs().max().item(),
            "max_point_diff_m": d.max().item(), "p99_point_diff_m": q[1],
            "median_point_diff_m": q[0]}


def _cg_vs_dense(sess, closure) -> dict:
    """Both routes of global BA and of the pose-graph correction on the loop
    phase's final state (F = 128, where both run): `_gba_impl` with the loop
    closer's dense and CG solvers (`global_ba_solver`) after a 1 cm
    perturbation of the keyframes, and
    `correct` of the first closure under a perturbed Sim3 with keyframe
    buckets of 128 (dense) and 256 (CG, at the reference's dense/CG switch,
    `reference_pose_graph_switch`). Per pair: the routes' difference,
    how far the dense route moved the state, each solve's chi2 (initial,
    final) and seconds, and each route's device operations per call."""
    import dataclasses

    from monocular_slam_tpu_torch.geometry import sim3
    from monocular_slam_tpu_torch.optim import pose_graph
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser

    lc, state = sess.loop_closer, sess.state
    dev = state.poses.device
    Fc = state.poses.shape[0]
    valid = state.pose_valid.cpu().numpy()
    kfs = [f for f in sess._keyframes if valid[f]]
    pad = torch.zeros(Fc, dtype=torch.long, device=dev)
    pad[: len(kfs)] = torch.as_tensor(kfs, device=dev)
    poses = state.poses.clone()
    g = torch.Generator(device=dev).manual_seed(3)
    poses[kfs[1:], :, 3] += 0.01 * torch.randn((len(kfs) - 1, 3), generator=g, device=dev)
    st = state._replace(poses=poses)
    chi2 = {}

    def keep(name, fn):
        def solve(*a, **kw):
            r = fn(*a, **kw)
            chi2[name] = [float(r.chi2_initial), float(r.chi2_history[-1])]
            return r
        return solve

    def row(a, b, base, t_a, t_b, names):
        moved = _state_diff(a, base, base)
        return {"dense_s": t_a, "cg_s": t_b, **_state_diff(a, b, base),
                "dense_moved_pose_m": moved["max_pose_diff_m"],
                "dense_moved_p99_point_m": moved["p99_point_diff_m"],
                "chi2_dense": chi2[names[0]], "chi2_cg": chi2[names[1]]}

    out = {}
    plain = pose_graph.optimize, pose_graph.optimize_cg
    pose_graph.optimize = keep("pg_dense", plain[0])
    pose_graph.optimize_cg = keep("pg_cg", plain[1])
    try:
        with torch.inference_mode(), reference_pose_graph_switch():
            dense, t_d, _ = _timed_solve(lambda: lc._gba_impl(
                st, pad, len(kfs), keep("ba_dense", lc.global_ba_solver(cg=False))))
            cg, t_c, _ = _timed_solve(lambda: lc._gba_impl(
                st, pad, len(kfs), keep("ba_cg", lc.global_ba_solver(cg=True))))
            out["global_ba"] = {"keyframes": len(kfs),
                                **row(dense, cg, st, t_d, t_c, ("ba_dense", "ba_cg"))}
            i, j = closure
            S = sim3.exp(torch.tensor([0.02, -0.01, 0.03, 0.05, 0.03, -0.04, 0.02], device=dev))
            res, closers = {}, {}
            for bucket, name in ((128, "dense"), (256, "cg")):
                c = LoopCloser(lc.voc, lc.cfg, dataclasses.replace(lc.lc, kf_bucket=bucket,
                                                                   run_global_ba=False), device=dev)
                c.loop_edges = list(lc.loop_edges)
                closers[name] = c
                res[bucket] = _timed_solve(lambda c=c: c.correct(state, i, j, S,
                                                                   keyframes=list(sess._keyframes)))
    finally:
        pose_graph.optimize, pose_graph.optimize_cg = plain
    (sd, ok_d), t_d, _ = res[128]
    (sc, ok_c), t_c, _ = res[256]
    if not (ok_d and ok_c and "pg_dense" in chi2 and "pg_cg" in chi2):
        raise AssertionError(f"cg vs dense: correct applied {ok_d}/{ok_c}, routes {sorted(chi2)}")
    out["correct"] = {"closure": [i, j], **row(sd, sc, state, t_d, t_c, ("pg_dense", "pg_cg"))}
    # device operations per closure on each route: the solvers' trip counts
    # are fixed, so these are the long run's counts per closure too
    with torch.inference_mode(), reference_pose_graph_switch():
        out["device_ops_per_call"] = {
            "global_ba_dense": device_ops(lambda: lc._gba_impl(
                st, pad, len(kfs), lc.global_ba_solver(cg=False))),
            "global_ba_cg_raw_and_summarized": device_ops(lambda: lc._gba_impl(
                st, pad, len(kfs), lc.global_ba_solver(cg=True)), summarized=True),
            **{f"correct_{name}": device_ops(lambda c=c: c.correct(state, i, j, S,
                                                                  keyframes=list(sess._keyframes)))
               for name, c in closers.items()},
        }
    return out


def phase_scale(loop_sess, loop_out, dev="cuda") -> dict:
    """The matrix-free solvers at benchmarks/kitti_scale.py's scale, then CG
    against dense on the loop phase's final state."""
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph

    dev = torch.device(dev)
    out = {}
    g = _scale_pose_graph(dev)
    first = _timed_solve(lambda: pose_graph.optimize_cg(g, n_iters=SCALE_ITERS))[1]
    res, dt, mem = _timed_solve(lambda: pose_graph.optimize_cg(g, n_iters=SCALE_ITERS))
    c0, c1, n_run = float(res.chi2_initial), float(res.chi2_history[-1]), int(res.n_iters_run)
    out["pose_graph"] = {"keyframes": SCALE_KF, "edges": int(g.valid.sum()), "lm_iters_run": n_run,
                         "s_per_lm_iter": dt / max(n_run, 1), "first_call_s": first,
                         "chi2_initial": c0, "chi2_final": c1, "peak_mem_mb": mem}
    log("[scale] pose graph " + json.dumps(out["pose_graph"]))
    if not (torch.isfinite(res.vertices).all() and c1 * 10 <= c0):
        raise AssertionError(f"scale: CG pose graph chi2 {c0} -> {c1}")

    prob, floor = _scale_ba_problem(dev)
    first = _timed_solve(lambda: cg_ba.bundle_adjust_cg(prob, n_iters=SCALE_ITERS, max_cg_iters=50))[1]
    res, dt, mem = _timed_solve(lambda: cg_ba.bundle_adjust_cg(prob, n_iters=SCALE_ITERS,
                                                               max_cg_iters=50))
    hist = res.chi2_history.tolist()
    c0, n_run = float(res.chi2_initial), int(res.n_iters_run)
    out["global_ba"] = {"frames": SCALE_BA[0], "points": SCALE_BA[1],
                        "edges": int(prob.cam_idx.shape[0]), "lm_iters_run": n_run,
                        "s_per_lm_iter": dt / max(n_run, 1), "first_call_s": first,
                        "chi2_initial": c0, "chi2_history": hist, "chi2_floor": floor,
                        "peak_mem_mb": mem}
    log("[scale] global BA " + json.dumps(out["global_ba"]))
    finite = bool(torch.isfinite(res.poses).all() and torch.isfinite(res.points).all())
    if not (finite and hist[-1] * 10 <= c0 and hist[-1] <= 2.0 * floor):
        raise AssertionError(f"scale: CG BA finite {finite}, chi2 {c0} -> {hist[-1]} "
                             f"(floor {floor})")

    out["cg_vs_dense"] = _cg_vs_dense(loop_sess, loop_out["closures"][0])
    log("[scale] CG vs dense on the loop state " + json.dumps(out["cg_vs_dense"]))
    for name in ("global_ba", "correct"):
        row = out["cg_vs_dense"][name]
        # the CG route must make the dense route's correction to within a
        # fraction of its size (PCG stops at 50 or 100 float32 steps); a few
        # weakly observed points move along their depth with the solver's
        # last digits, so points are held at their 99th percentile
        f_pose, f_point = CG_VS_DENSE_FRAC
        if not (row["max_pose_diff_m"] <= f_pose * row["dense_moved_pose_m"]
                and row["p99_point_diff_m"] <= f_point * row["dense_moved_p99_point_m"]):
            raise AssertionError(f"scale: {name}: the CG route's correction differs from the "
                                 f"dense route's by more than {CG_VS_DENSE_FRAC} of it: {row}")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _nccl_kernels(fn) -> dict:
    """NCCL's share of one call of fn under `torch.profiler`: device kernels
    whose name holds "nccl", and the process group's `nccl:all_reduce`
    host events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = prof.key_averages()
    return {"device_kernels": sum(e.count for e in ev if e.device_type == cuda
                                  and "nccl" in e.key.lower()),
            "nccl_all_reduce_events": sum(e.count for e in ev if e.key == "nccl:all_reduce")}


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def _maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _dist_problem(dev, F=DIST_BA[0], P=DIST_BA[1], obs=DIST_BA[2], seed=8):
    """The two-rank check's problem (numpy draws): F cameras on an arc
    looking at P points in a box 12 m ahead, obs random observations per
    camera with 0.5 px noise, poses perturbed by 0.003-sigma twists,
    points by 0.05 m; cameras 0 and 1 fixed. float32."""
    from monocular_slam_tpu_torch.geometry import se3, so3
    from monocular_slam_tpu_torch.optim import ba

    rng = np.random.RandomState(seed)
    X = rng.uniform(-3, 3, (P, 3)) + [0.0, 0.0, 12.0]
    f64 = torch.float64
    poses = se3.from_Rt(so3.exp(torch.tensor([[0.0, 0.005 * i, 0.0] for i in range(F)], dtype=f64)),
                        torch.tensor([[-0.05 * i, 0.0, 0.0] for i in range(F)], dtype=f64))
    cam = np.repeat(np.arange(F), obs)
    pt = rng.randint(0, P, F * obs)
    Xc = se3.apply(poses[torch.as_tensor(cam)], torch.as_tensor(X[pt])).numpy()
    k = np.array([500.0, 500.0, 320.0, 240.0])
    uv = k[:2] * Xc[:, :2] / Xc[:, 2:] + k[2:] + 0.5 * rng.randn(F * obs, 2)
    fixed = np.zeros(F, bool)
    fixed[:2] = True
    p0 = se3.compose(se3.exp(torch.as_tensor(0.003 * rng.randn(F, 6))), poses)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return ba.BAProblem(f32(p0), f32(X + 0.05 * rng.randn(P, 3)), f32(np.tile(k, (F, 1))),
                        torch.as_tensor(cam, device=dev), torch.as_tensor(pt, device=dev), f32(uv),
                        torch.ones(F * obs, device=dev),
                        torch.ones(F * obs, dtype=torch.bool, device=dev),
                        torch.as_tensor(fixed, device=dev))


def dist_rank() -> int:
    """One of the two gloo ranks of the dist phase (`chip_smoke.py
    dist-rank`, started with MSLAM_COORDINATOR / MSLAM_NUM_PROCESSES /
    MSLAM_PROCESS_ID): CUDA tensors on the one card, `initialize` from the
    variables, the seeded problem through "auto" (dense at 2 shards) and
    "cg", and the golden fixture; rank 0 also runs the single-device
    routes. Prints one DIST_RANK JSON line."""
    import torch.distributed as dist

    from monocular_slam_tpu_torch.io import snapshot
    from monocular_slam_tpu_torch.optim import ba, cg_ba
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba

    multi = distributed.initialize(device="cuda", backend="gloo")
    rank = dist.get_rank()
    mesh = distributed.global_mesh(device="cuda")
    prob = _dist_problem("cuda")
    out = {"rank": rank, "world": dist.get_world_size(), "multi": multi,
           "backend": dist.get_backend(), "mesh_model": mesh.size(1)}
    for solver, single_fn in (("auto", lambda: ba.bundle_adjust(prob, n_iters=SCALE_ITERS)),
                              ("cg", lambda: cg_ba.bundle_adjust_cg(prob, n_iters=SCALE_ITERS,
                                                                    max_cg_iters=100))):
        res, t, _ = _timed_solve(lambda: sharded_ba.distributed_bundle_adjust(
            prob, mesh, n_iters=SCALE_ITERS, solver=solver, max_cg_iters=100))
        row = {"s": t, "chi2_initial": float(res.chi2_initial),
               "chi2_final": float(res.chi2_history[-1]),
               "finite": bool(torch.isfinite(res.poses).all() and torch.isfinite(res.points).all())}
        if rank == 0:
            ref, t_ref, _ = _timed_solve(single_fn)
            row |= {"single_s": t_ref, "single_chi2_final": float(ref.chi2_history[-1]),
                    "chi2_final_rel_diff": _rel(res.chi2_history[-1], ref.chi2_history[-1]),
                    "max_pose_diff": _maxdiff(res.poses, ref.poses),
                    "p99_point_diff_m": float(torch.quantile(
                        torch.linalg.norm(res.points - ref.points, dim=-1), 0.99))}
        out[solver] = row
    golden = snapshot.load_ba_problem(str(ROOT / "tests/fixtures/ba_problem.npz"), device="cuda")
    exp = np.load(ROOT / "tests/fixtures/ba_expected.npz")
    res = sharded_ba.distributed_bundle_adjust(golden, mesh, n_iters=15)
    out["golden_max_pose_diff"] = float(np.abs(res.poses.cpu().numpy() - exp["poses"]).max())
    print("DIST_RANK " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def _two_gloo_ranks() -> list:
    """Both gloo ranks as processes on the one card, rendezvous on a
    localhost port; waits for both and kills neither-finished one."""
    port = _free_port()
    env0 = dict(os.environ, MSLAM_COORDINATOR=f"localhost:{port}", MSLAM_NUM_PROCESSES="2",
                PYTHONPATH=os.pathsep.join([str(ROOT)] + [
                    p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "dist-rank"],
                              env=dict(env0, MSLAM_PROCESS_ID=str(r)), cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DIST_RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"dist: a gloo rank exited {p.returncode}:\n{err[-3000:]}")
            reports += [json.loads(x.split(" ", 1)[1]) for x in out.splitlines()
                        if x.startswith("DIST_RANK ")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return sorted(reports, key=lambda r: r["rank"])


def phase_dist(sess_out, loop_sess) -> dict:
    """The distributed solvers on the card: NCCL at world size 1 in this
    process against the single-device routes at the scale phase's width,
    the dense route on the loop state, two gloo ranks on the same card, and
    the repeat check (CG BA, CG pose graph, the 60-frame session, each run
    twice, bit-identical)."""
    import torch.distributed as dist

    from monocular_slam_tpu_torch.optim import ba, cg_ba, pose_graph
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba, sharded_pose_graph
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        out["backend"] = dist.get_backend(mesh.get_group("model"))
        prob, _ = _scale_ba_problem("cuda")
        F = prob.poses.shape[0]
        kw = dict(n_iters=SCALE_ITERS, max_cg_iters=50)
        # two calls of each route; the second is timed (the first of the
        # sharded route also sets up NCCL's communicator)
        single = [_timed_solve(lambda: cg_ba.bundle_adjust_cg(prob, **kw)) for _ in range(2)]
        with distributed.record_collectives() as rec:
            shard = [_timed_solve(lambda: sharded_ba.distributed_bundle_adjust(
                prob, mesh, solver="cg", cg_rtol=1e-8, **kw)) for _ in range(2)]
        (s1, _, _), (s2, t_s, _) = single
        (d1, _, _), (d2, t_d, mem_d) = shard
        per_call = len(rec) // 2
        solve = [c for c in rec[:per_call] if c["label"] != "gather"]  # the LM loop's
        pcg = [c for c in solve if c["elements"] == 6 * F]
        out["global_ba"] = {
            "edges": int(prob.cam_idx.shape[0]), "s_per_lm_iter_single": t_s / SCALE_ITERS,
            "s_per_lm_iter_sharded": t_d / SCALE_ITERS, "peak_mem_mb_sharded": mem_d,
            "chi2_history_rel_diff": _rel(d2.chi2_history, s2.chi2_history),
            "max_pose_diff": _maxdiff(d2.poses, s2.poses),
            "max_point_diff": _maxdiff(d2.points, s2.points),
            "all_reduce_calls": per_call, "all_reduce_6F_calls": len(pcg),
            "pcg_steps": SCALE_ITERS * kw["max_cg_iters"],
            "bytes_per_pcg_step": pcg[0]["bytes"] if pcg else None,
            "largest_all_reduce_elements": max(c["elements"] for c in solve),
            "gather_elements": [c["elements"] for c in rec[:per_call] if c["label"] == "gather"],
            "repeat_bit_identical_single": bool(torch.equal(s1.poses, s2.poses)
                                                and torch.equal(s1.points, s2.points)),
            "repeat_bit_identical_sharded": bool(torch.equal(d1.poses, d2.poses)
                                                 and torch.equal(d1.points, d2.points)),
        }
        out["global_ba"]["nccl"] = _nccl_kernels(lambda: sharded_ba.distributed_bundle_adjust(
            prob, mesh, n_iters=1, solver="cg", max_cg_iters=10))
        log("[dist] NCCL world 1, CG BA " + json.dumps(out["global_ba"]))

        g = _scale_pose_graph("cuda")
        pg_single = [_timed_solve(lambda: pose_graph.optimize_cg(g, n_iters=SCALE_ITERS))
                     for _ in range(2)]
        with distributed.record_collectives() as rec:
            pg_shard = [_timed_solve(lambda: sharded_pose_graph.distributed_optimize(
                g, mesh, n_iters=SCALE_ITERS)) for _ in range(2)]
        (p1, _, _), (p2, t_ps, _) = pg_single
        pd, t_pd, _ = pg_shard[1]
        rec = rec[: len(rec) // 2]
        Fk = g.vertices.shape[0]
        out["pose_graph"] = {
            "keyframes": Fk, "s_per_lm_iter_single": t_ps / SCALE_ITERS,
            "s_per_lm_iter_sharded": t_pd / SCALE_ITERS,
            "chi2_history_rel_diff": _rel(pd.chi2_history, p2.chi2_history),
            "max_vertex_diff": _maxdiff(pd.vertices, p2.vertices),
            "all_reduce_calls": len(rec),
            "all_reduce_7F_calls": sum(c["elements"] == 7 * Fk for c in rec),
            "bytes_per_pcg_step": 7 * Fk * 4,
            "repeat_bit_identical_single": bool(torch.equal(p1.vertices, p2.vertices)),
        }
        log("[dist] NCCL world 1, pose graph " + json.dumps(out["pose_graph"]))

        captured = {}
        lc, st = loop_sess.loop_closer, loop_sess.state
        valid = st.pose_valid.cpu().numpy()
        kfs = [f for f in loop_sess._keyframes if valid[f]]
        pad = torch.zeros(st.poses.shape[0], dtype=torch.long, device="cuda")
        pad[: len(kfs)] = torch.as_tensor(kfs, device="cuda")
        n = lc.lc.global_ba_iters

        def capture(pr):
            captured["prob"] = pr
            return ba.bundle_adjust(pr, n_iters=n)

        with torch.inference_mode():
            lc._gba_impl(st, pad, len(kfs), capture)
            pr = captured["prob"]
            ref, t_ref, _ = _timed_solve(lambda: ba.bundle_adjust(pr, n_iters=n))
            dd, t_dd, _ = _timed_solve(lambda: sharded_ba.distributed_bundle_adjust(
                pr, mesh, n_iters=n, solver="dense"))
        out["dense_loop_state"] = {
            "frames": int(pr.poses.shape[0]), "points": int(pr.points.shape[0]),
            "edges": int(pr.valid.sum()), "s_single": t_ref, "s_sharded": t_dd,
            "chi2_history_rel_diff": _rel(dd.chi2_history, ref.chi2_history),
            "max_pose_diff": _maxdiff(dd.poses, ref.poses)}
        log("[dist] NCCL world 1, dense on the loop state " + json.dumps(out["dense_loop_state"]))
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = _two_gloo_ranks()
    out["gloo_two_ranks"] = {"s": time.perf_counter() - t0, "ranks": ranks}
    log("[dist] two gloo ranks on the card " + json.dumps(out["gloo_two_ranks"]))

    again = run_session(sess_out["imgs"], sess_out["poses_gt"], sess_out["k"], count_syncs=False)
    out["session_repeat_bit_identical"] = bool(np.array_equal(again["poses"], sess_out["poses"]))
    log(f"[dist] repeat: CG BA {out['global_ba']['repeat_bit_identical_single']} (sharded "
        f"{out['global_ba']['repeat_bit_identical_sharded']}), CG pose graph "
        f"{out['pose_graph']['repeat_bit_identical_single']}, 60-frame session "
        f"{out['session_repeat_bit_identical']}")

    fails = []
    gb, pg, dl = out["global_ba"], out["pose_graph"], out["dense_loop_state"]
    if out["backend"] != "nccl" or gb["nccl"]["nccl_all_reduce_events"] < 1:
        fails.append(f"the collectives did not go through NCCL: {out['backend']}, {gb['nccl']}")
    for name, row, key in (("CG BA", gb, "max_pose_diff"), ("pose graph", pg, "max_vertex_diff"),
                           ("dense loop-state BA", dl, "max_pose_diff")):
        if not (row["chi2_history_rel_diff"] <= DIST_RTOL and row[key] <= DIST_POSE_TOL):
            fails.append(f"{name}: sharded vs single-device {row}")
    if gb["all_reduce_6F_calls"] != SCALE_ITERS * (gb["pcg_steps"] // SCALE_ITERS + 1):
        fails.append(f"CG BA: {gb['all_reduce_6F_calls']} (F, 6) all-reduces")
    if gb["largest_all_reduce_elements"] > 100 * F:
        fails.append(f"CG BA: an all-reduce of {gb['largest_all_reduce_elements']} elements")
    for r in ranks:
        for solver in ("auto", "cg"):
            row = r[solver]
            if not (row["finite"] and row["chi2_final"] < row["chi2_initial"]):
                fails.append(f"gloo rank {r['rank']} {solver}: {row}")
        if r["golden_max_pose_diff"] >= 1e-5:
            fails.append(f"gloo rank {r['rank']}: golden fixture {r['golden_max_pose_diff']}")
    if len(ranks) != 2 or any(r["backend"] != "gloo" or not r["multi"] for r in ranks):
        fails.append(f"gloo ranks: {ranks}")
    for solver, (tol_chi2, tol_pose) in DIST_GLOO_TOL.items():
        row = ranks[0][solver] if ranks else {}
        if not (row.get("chi2_final_rel_diff", 1) <= tol_chi2
                and row.get("max_pose_diff", 1) <= tol_pose):
            fails.append(f"gloo {solver} vs single device: {row}")
    if not (gb["repeat_bit_identical_single"] and gb["repeat_bit_identical_sharded"]
            and pg["repeat_bit_identical_single"] and out["session_repeat_bit_identical"]):
        fails.append("a repeated run differed in its bits")
    if fails:
        raise AssertionError("dist: " + "; ".join(fails))
    return out


def phase_mesh(cli_out) -> dict:
    """`estimate_normals` + `poisson_mesh` on the card: the cli phase's
    map.ply points and the 4000-point unit sphere (watertight)."""
    from monocular_slam_tpu_torch.viz import mesh

    out = {}
    rng = np.random.RandomState(0)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for name, pts, kw in (("map", cli_out["map_points"], {}),
                          ("sphere", d, {"depth": 5})):
        x = torch.as_tensor(pts, dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        normals = mesh.estimate_normals(x, k=16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, t = mesh.poisson_mesh(x, normals=normals, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r = torch.linalg.norm(v - x.mean(0), dim=1)
        out[name] = {"points": int(x.shape[0]), "normals_s": t1 - t0, "poisson_s": t2 - t1,
                     "verts": int(v.shape[0]), "tris": int(t.shape[0]),
                     "boundary_edges": mesh.mesh_boundary_edges(t),
                     "finite": bool(torch.isfinite(v).all() and torch.isfinite(normals).all()),
                     "radius_mean": float(r.mean()), "radius_std": float(r.std())}
    log("[mesh] " + json.dumps(out))
    m, s = out["map"], out["sphere"]
    if not (m["finite"] and m["tris"] > 0 and s["finite"] and s["tris"] > 1000
            and s["boundary_edges"] == 0 and abs(s["radius_mean"] - 1.0) < 0.05):
        raise AssertionError(f"mesh: {out}")
    return out


def run_long(n: int, dev="cuda") -> tuple[dict, object]:
    """benchmarks/long_run.py's configuration on the card: n frames of the
    seed-19 orbit at 0.05 rad/frame, 640x480, rendered into one uint8 buffer
    on the card and fed through `add_frame_from_buffer` after
    `prewarm(image=True)`; 1000 continuous-steered features, 256 slots,
    max_points 30000, max_frames n + 32, the bundled vocabulary, min_gap
    and cooldown 60. K1 and K2 are counted from 0 after the prewarm; the
    solver routes of the loop closer and each Sim3 are recorded."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser, LoopClosureConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    dev = torch.device(dev)
    t0 = time.perf_counter()
    imgs, poses_gt, k = render.render_sequence(seed=19, n_frames=n, wh=WH, ang_step=0.05, device=dev)
    buf = imgs.to(torch.uint8)
    del imgs
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    cfg = SlamConfig(max_frames=n + 32, max_slots=256, max_points=30000, image_wh=WH,
                     frontend=FrontendConfig(n_features=1000, steer_mode="continuous"))
    lc = LoopCloser(vocabulary.load_default(dev), cfg, LoopClosureConfig(min_gap=60, cooldown=60),
                    device=dev)
    sess = SlamSession(cfg, seed=0, run_ba=True, loop_closer=lc, device=dev)
    prewarm_s = sess.prewarm(image=True)

    routes = {"optimize": [], "optimize_cg": [], "bundle_adjust_cg": []}
    track_k2, sim3_s, closes = [], [], []
    undo = []

    def wrap(owner, attr, record):
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            return record(orig, *a, **kw)

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))

    def solve(name, size):
        def record(orig, x, *a, **kw):
            res = orig(x, *a, **kw)
            routes[name].append({"frame": sess._next - 1, "size": size(x),
                                 "chi2": [float(res.chi2_initial), float(res.chi2_history[-1])],
                                 "lm_iters_run": int(res.n_iters_run)})
            return res
        return record

    def close(orig, state, i, j, *a, **kw):
        state, closed = orig(state, i, j, *a, **kw)
        c = -torch.einsum("fji,fj->fi", state.poses[:, :, :3], state.poses[:, :, 3])[state.pose_valid]
        closes.append({"i": i, "j": j, "closed": closed,
                       "max_center_norm": torch.linalg.norm(c, dim=-1).max().item()})
        return state, closed

    def track(orig, *a, **kw):
        before = hamming.LAUNCHES
        res = orig(*a, **kw)
        track_k2.append(hamming.LAUNCHES - before)
        return res

    def timed_sim3(orig, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = orig(*a, **kw)
        torch.cuda.synchronize()
        sim3_s.append(time.perf_counter() - t)
        return res

    wrap(pose_graph, "optimize", solve("optimize", lambda g: int(g.vertices.shape[0])))
    wrap(pose_graph, "optimize_cg", solve("optimize_cg", lambda g: int(g.vertices.shape[0])))
    wrap(cg_ba, "bundle_adjust_cg", solve("bundle_adjust_cg", lambda p: int(p.valid.sum())))
    wrap(tracker, "track", track)
    wrap(lc, "compute_sim3", timed_sim3)
    wrap(lc, "close", close)
    fast_score.LAUNCHES = hamming.LAUNCHES = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            if i == 50:
                torch.cuda.synchronize()
                t50 = time.perf_counter()
            sess.add_frame_from_buffer(buf, i, k, i / 30.0)
        sess.flush()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    k1, k2 = fast_score.LAUNCHES, hamming.LAUNCHES
    poses, valid, _ = sess.trajectory()
    # a pose whose camera centre ran off past 1e6 counts as non-finite
    with np.errstate(all="ignore"):
        centers = np.abs(ate_mod.camera_centers(poses.astype(np.float64))).max(1)
        finite = centers < 1e6
    ok = valid & finite
    r = ate_mod.ate(poses[ok], poses_gt[ok])
    # rotation blocks that stopped being rotations (|det R - 1| > 1e-2)
    det_dev = np.abs(np.linalg.det(np.where(ok[:, None, None], poses, 0.0)[:, :, :3]
                                   .astype(np.float64)) - 1.0)
    rigid = ok & (det_dev <= 1e-2)
    nr = max(lc.timings["n_runs"], 1)
    out = {
        "frames": n, "render_s": render_s, "prewarm_s": prewarm_s, "tracked": int(valid.sum()),
        "nonfinite_poses": int((valid & ~finite).sum()), "ate_m": r.rmse,
        "max_rotation_det_dev": float(det_dev[ok].max()), "nonrigid_poses": int((ok & ~rigid).sum()),
        "ate_m_rigid_poses": ate_mod.ate(poses[rigid], poses_gt[rigid]).rmse, "fps": n / (t1 - t0),
        "fps_50_on": (n - 50) / (t1 - t50) if n > 50 else None, "wall_s": t1 - t0, "closures": lc.closures,
        "corrected": lc.corrected, "skipped_identity": lc.skipped_identity,
        "reverted": lc.reverted, "keyframes_promoted": len(sess._keyframes),
        "keyframes_live": len(sess.keyframes), "frames_evicted": int((sess.state.slot_of[:n] < 0).sum()),
        "routes": routes, "reloc_attempts": sess.reloc_attempts,
        "reloc_successes": sess.reloc_successes, "k1_launches": k1, "k2_launches": k2,
        "track_calls": len(track_k2), "k2_per_track_min": min(track_k2, default=0),
        "sim3_s": sim3_s, "close_calls": closes, "closure_timings_s": lc.timings,
        "closure_s_per_run": {s: lc.timings[s] / nr for s in ("sim3", "pose_graph", "global_ba")},
    }
    return out, sess


@contextlib.contextmanager
def reference_pose_graph_switch():
    """The loop closer's pose graph at the reference's dense/CG switch, 128
    keyframes, in place of the port's `POSE_GRAPH_DENSE_MAX` (512, past a
    1000-frame run), so that a shorter run or a 256-keyframe bucket reaches
    the CG route."""
    from monocular_slam_tpu_torch.slam import loop_closer

    port = loop_closer.POSE_GRAPH_DENSE_MAX
    loop_closer.POSE_GRAPH_DENSE_MAX = 128
    try:
        yield
    finally:
        loop_closer.POSE_GRAPH_DENSE_MAX = port


def phase_long() -> dict:
    with reference_pose_graph_switch():
        out, _ = run_long(LONG_FRAMES)
    log("[long] " + json.dumps(out))
    n = out["frames"]
    log(f"[long] {n} frames: tracked {out['tracked']}, ATE {out['ate_m'] * 100:.2f} cm "
        f"(max |det R - 1| {out['max_rotation_det_dev']:.2g}), "
        f"{out['fps']:.2f} fps ({out['fps_50_on']:.2f} from frame 50), prewarm "
        f"{out['prewarm_s']:.2f} s, closures {out['closures']}, first Sim3 "
        f"{out['sim3_s'][0] if out['sim3_s'] else float('nan'):.3f} s, routes "
        f"{ {r: len(c) for r, c in out['routes'].items()} }, evicted {out['frames_evicted']}, "
        f"K1 {out['k1_launches']}, K2 {out['k2_launches']} in {out['track_calls']} track calls")
    if out["nonfinite_poses"]:
        raise AssertionError(f"long: {out['nonfinite_poses']} non-finite poses")
    if out["tracked"] < 0.95 * n:
        raise AssertionError(f"long: tracked {out['tracked']} < 95% of {n}")
    if len(out["closures"]) < 2:
        raise AssertionError(f"long: {len(out['closures'])} closures < 2")
    if not out["routes"]["optimize_cg"] or not out["routes"]["bundle_adjust_cg"]:
        raise AssertionError(f"long: a CG route was never taken: {out['routes']}")
    if out["frames_evicted"] < 1:
        raise AssertionError("long: no feature slot was evicted")
    if out["k1_launches"] != n:
        raise AssertionError(f"long: K1 launched {out['k1_launches']} times for {n} frames")
    if out["k2_per_track_min"] < 2:
        raise AssertionError(f"long: a track call launched K2 {out['k2_per_track_min']} times")
    return out


def _cli_json(lines, prefix=None):
    """The JSON object on the last line (or on the line after `prefix`)."""
    if prefix is None:
        return json.loads(lines[-1])
    return json.loads(next(x for x in lines if x.startswith(prefix))[len(prefix):])


def _run_main_inprocess(argv) -> tuple[dict, list]:
    """`run.main(argv)` in this process; returns (summary, stdout lines)."""
    from monocular_slam_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"run.main({argv}) returned {rc}")
    return _cli_json(lines), lines


def _write_kitti(root: str, imgs_u8: np.ndarray, poses: np.ndarray, k: np.ndarray) -> None:
    """KITTI odometry layout: sequences/00/image_0/%06d.png, times.txt,
    calib.txt (P0), poses/00.txt (camera-to-world rows)."""
    from monocular_slam_tpu_torch import native

    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"))
    os.makedirs(os.path.join(root, "poses"))
    for i, img in enumerate(imgs_u8):
        native.write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), img)
    np.savetxt(os.path.join(seq, "times.txt"), np.arange(len(imgs_u8)) / 30.0)
    P = np.array([[k[0], 0, k[2], 0], [0, k[1], k[3], 0], [0, 0, 1, 0]])
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n")
    R, t = poses[:, :, :3].astype(np.float64), poses[:, :, 3].astype(np.float64)
    c2w = np.concatenate([R.transpose(0, 2, 1), -np.einsum("fji,fj->fi", R, t)[..., None]], -1)
    np.savetxt(os.path.join(root, "poses", "00.txt"), c2w.reshape(len(imgs_u8), 12))


def cli_course(work: str) -> dict:
    """The CLI phase's course: rendered on the card, written as a TUM
    directory under `work`, decoded back and checked against the rendered
    uint8 frames bit for bit."""
    from monocular_slam_tpu_torch.datasets import render, tum

    t0 = time.perf_counter()
    imgs, poses_gt, k = render.render_sequence(seed=19, n_frames=CLI_FRAMES, wh=WH,
                                               ang_step=0.05, device="cuda")
    u8 = imgs.to(torch.uint8).cpu().numpy()
    del imgs
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    root = render.write_tum(os.path.join(work, "tum"), u8, poses_gt, k)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = tum.load(root)
    dec = seq.load_images_batch(range(len(seq.frames)))
    decode_s = time.perf_counter() - t0
    if len(dec) != CLI_FRAMES or not all(np.array_equal(d, u) for d, u in zip(dec, u8)):
        raise AssertionError("cli: decoded frames differ from the rendered uint8 frames")
    log(f"[cli] rendered {CLI_FRAMES} frames on the card in {render_s:.2f} s, wrote the TUM "
        f"directory in {write_s:.2f} s, decoded it in {decode_s:.3f} s: equal bit for bit")
    return {"root": root, "u8": u8, "poses_gt": poses_gt, "k": k, "render_s": render_s,
            "write_s": write_s, "decode_s": decode_s}


def cli_args(root: str, out_dir: str) -> list:
    return ["--dataset", root, "--start", "0", "--end", str(CLI_FRAMES), "--step", "1",
            "--loop-closure", "--vocab", "default", "--out", out_dir]


def phase_cli() -> dict:
    from monocular_slam_tpu_torch.eval import compare
    from monocular_slam_tpu_torch.io import ply, trajectory

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        course = cli_course(work)
        root, u8, poses_gt, k = course["root"], course["u8"], course["poses_gt"], course["k"]
        out_dir = os.path.join(work, "out")
        cmd = [sys.executable, "-m", "monocular_slam_tpu_torch.run",
               *cli_args(root, out_dir), "--verbose"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                              env=env, cwd=str(ROOT))
        proc_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli: the CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        summary = _cli_json(lines)
        counts = _cli_json(lines, "[run] kernel launches ")
        plot = next((x for x in lines if x.startswith("[run] plot")), "plot written")
        ts, poses = trajectory.read_tum(os.path.join(out_dir, "trajectory.txt"))
        pts = ply.read_ply_points(os.path.join(out_dir, "map.ply"))
        cmp = compare.compare(os.path.join(out_dir, "trajectory.txt"),
                              os.path.join(root, "groundtruth.txt"))
        closures = summary.get("loop_closures", [])
        out = {"summary": summary, "kernel_launches": counts, "subprocess_s": proc_s,
               "trajectory_rows": len(ts), "map_ply_points": int(pts.shape[0]),
               "compare": cmp, "plot": plot,
               **{n: course[n] for n in ("render_s", "write_s", "decode_s")}}
        log("[cli] " + json.dumps(out))
        log(f"[cli] CLI on {CLI_FRAMES} frames: tracked {summary['tracked']}, ATE "
            f"{summary['ate_rmse'] * 100:.3f} cm (eval.compare {cmp['ate_rmse'] * 100:.5f} cm), "
            f"closures {closures}, {summary['fps_incl_compile']} fps, prewarm "
            f"{summary['prewarm_s']} s, wall {summary['wall_s']} s ({proc_s:.1f} s for the "
            f"process), K1 {counts['fast_corner_maps_levels']}, K2 {counts['hamming_top2']} in "
            f"{counts['track_calls']} track calls; {plot}")
        if summary["tracked"] < CLI_MIN_TRACKED:
            raise AssertionError(f"cli: tracked {summary['tracked']} < {CLI_MIN_TRACKED}")
        if not summary["ate_rmse"] <= CLI_MAX_ATE_M:
            raise AssertionError(f"cli: ATE {summary['ate_rmse']} m > {CLI_MAX_ATE_M} m")
        if not abs(cmp["ate_rmse"] - summary["ate_rmse"]) <= 1e-5:
            raise AssertionError(f"cli: eval.compare ATE {cmp['ate_rmse']} != summary "
                                 f"{summary['ate_rmse']}")
        if len(ts) != summary["tracked"] or pts.shape[0] != summary["map_points"]:
            raise AssertionError(f"cli: {len(ts)} trajectory rows, {pts.shape[0]} PLY points "
                                 f"for {summary}")
        if not any(i - j >= 40 for i, j in closures):
            raise AssertionError(f"cli: no closure with i - j >= 40: {closures}")
        if counts["fast_corner_maps_levels"] != CLI_FRAMES:
            raise AssertionError(f"cli: K1 launched {counts['fast_corner_maps_levels']} times "
                                 f"for {CLI_FRAMES} frames")
        if counts["track_calls"] < CLI_MIN_TRACKED - 2 or counts["k2_per_track_min"] < 2:
            raise AssertionError(f"cli: K2: {counts}")

        kitti_root = os.path.join(work, "kitti")
        _write_kitti(kitti_root, u8[:KITTI_FRAMES], poses_gt[:KITTI_FRAMES], k)
        kitti, _ = _run_main_inprocess(["--dataset", kitti_root, "--end", str(KITTI_FRAMES),
                                        "--step", "1", "--out", os.path.join(work, "kitti_out")])
        log("[cli] KITTI layout " + json.dumps(kitti))
        if kitti["tracked"] < KITTI_MIN_TRACKED:
            raise AssertionError(f"cli: KITTI tracked {kitti['tracked']} < {KITTI_MIN_TRACKED}")

        synth, _ = _run_main_inprocess(["--dataset", "synthetic",
                                        "--out", os.path.join(work, "synth_out")])
        log("[cli] synthetic " + json.dumps(synth))
        if not np.isfinite(synth.get("ate_rmse", np.nan)) or "tracked" not in synth:
            raise AssertionError(f"cli: synthetic route reported {synth}")
        out |= {"kitti": kitti, "synthetic": synth}
        out["map_points"] = pts  # for the mesh phase
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    phase_device()
    timed("build", phase_build)
    res = timed("session", phase_session)
    k2 = timed("k2", phase_k2, res["imgs"])
    timed("lc60", phase_lc60, res)
    loop, loop_sess = timed("loop", phase_loop)
    timed("scale", phase_scale, loop_sess, loop)
    timed("dist", phase_dist, res, loop_sess)
    timed("long", phase_long)
    cli = timed("cli", phase_cli)
    timed("mesh", phase_mesh, cli)
    log("[done] seconds by phase " + json.dumps(seconds))
    k1 = res["k1"]
    win = k2[WINDOW]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; loop K1 launches "
        f"{loop['k1_launches']}, K2 launches {loop['k2_launches']}")
    log(json.dumps({"kernels": [
        {"name": "fast_corner_maps_levels", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": res["k1_launches"],
         "launches_cli": cli["kernel_launches"]["fast_corner_maps_levels"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "hamming_top2", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": res["k2_launches"],
         "launches_cli": cli["kernel_launches"]["hamming_top2"],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()), "ms": win["ms"],
         "plain_ms": win["plain_ms"], "bound_ms": win["bound_ms"], "bound_by": win["bound_by"],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["dist-rank"]:
        sys.exit(dist_rank())
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    sys.exit(main())
