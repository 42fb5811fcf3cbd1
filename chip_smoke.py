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
                last frame against its predecessor.

Every phase raises on failure. Kernel launch counts are set to 0 just
before each path is driven and read just after; the kernels JSON reports
the session's measured run. The second-to-last line is
the kernels JSON, the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

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
    return out


def main() -> int:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    res = phase_session()
    k2 = phase_k2(res["imgs"])
    phase_lc60(res)
    loop = phase_loop()
    k1 = res["k1"]
    win = k2[WINDOW]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; loop K1 launches "
        f"{loop['k1_launches']}, K2 launches {loop['k2_launches']}")
    log(json.dumps({"kernels": [
        {"name": "fast_corner_maps_levels", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": res["k1_launches"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "hamming_top2", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": res["k2_launches"],
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
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    sys.exit(main())
