"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py program    # device, build, k3, pose_gn and program only
    python3 chip_smoke.py loop       # device, build and loop only (long, bench, drivers: the same)

Drives the port's main paths (`monocular_slam_tpu_torch`, no JAX) at the
benchmark's full width and checks them. Every session runs its tracked
frames through the captured step programs (`slam/session.py`: two CUDA
graph replays a frame) and every other device stage through its captured
program, except the op-by-op A/B runs of the program and loop phases:

  1. device   — requires CUDA; prints the card's name and power limit;
  2. build    — compiles K1 (`csrc/fast_score.cu`), K2
                (`csrc/hamming_top2.cu`), K3 (`csrc/small_eigh.cu`) and
                `pose_gn` (`csrc/pose_gn.cu`) from the checkout, one nvcc
                each, all started together;
  3. draws    — the session's keyed RANSAC draws (`prng.uniform_on`, torch
                int64 ops on the card) bit for bit against the numpy
                `prng.uniform` / `random_bits` at the session's three shapes
                (PnP 512 x 1000, bootstrap 2000 x 1000, Sim3 256 x 1000) and
                two odd ones, under three seeds; event-timed ms per draw and
                per `_sample_indices` call; then the port's session on the
                card over the reference's key-3 course (12 frames, 320x240,
                seed 0, frames from the committed fixture
                tests/fixtures/reference_session_key3.npz, which the JAX
                session wrote on the CPU): tracked flags, keyframes and the
                final session key must equal the fixture's, rotations within
                REF_ROT_TOL and translations within REF_TRANS_TOL of their
                length (the CPU test's tolerance); K1 and K2 must launch;
  4. K1       — the one-launch kernel vs its plain PyTorch version on the 8
                pyramid levels of a rendered 640x480 frame, and the
                one-level call on 101x173: nms map within 1e-5 everywhere,
                raw map within 1e-5 on the interior (>= 3 px from the
                edge); per frame the median CUDA-event-timed call over 50,
                the kernel's device time from `torch.profiler`, the bound;
  5. extract  — ORB extraction with K1 and with the plain maps: identical
                keypoint sets and descriptors, both steer modes;
  6. session  — the 60-frame 640x480 course rendered on the card through
                `SlamSession.add_frame` with the benchmark's configuration
                (max_frames 64, max_points 20000, 1000 features, 8 levels,
                steer_mode "auto", seed 1, BA on): one warm-up run with the
                tracker's window forced onto the dense route, which also
                counts host syncs, then the measured run, whose window goes
                through K2. Fails below 54/60 tracked, above 3 cm ATE, if
                the two trajectories differ by more than 1e-6 m, below one
                K1 launch per frame, below 2 K2 launches in any tracked
                frame, below one K3 eigh and one svd3 launch per tracked
                frame, or below two `pose_gn` launches in any tracked frame
                (PnP's polish and the local-map refine); each session calls
                `prewarm(image=True)` first;
 6a. k3       — K3 vs its plain version (`torch.linalg.eigh` / `svd`, also
                the library call) at the step's shapes: eigh of (1000, 4,
                4) and (1, 12, 12), svd3 of (1, 3, 3) and (512, 3, 3);
                values within K3_TOL of the largest, vectors
                |<v, v_plain>| >= 1 - K3_TOL where the gap exceeds K3_GAP of
                the largest, U S Vt within K3_TOL; ms, device ms, bound
                (the kernels line carries every shape under `shapes`);
 6b. program  — the session's course through the captured programs, with
                host syncs over frames 10-59 (`set_sync_debug_mode` warnings
                plus the flag reads plus lagged reads that waited), against
                the same functions run op by op on the card: flags and
                keyframes equal, poses within 1e-6 m, syncs <= 1 a frame;
                fps of both, capture seconds and graph-pool memory of a
                prewarmed session, a profile of frames 13-22's replays
                (K1, K2 at least twice, K3's eigh and svd3 in every frame,
                `pose_gn` twice;
                device operations, device ms and K3's device ms a frame)
                and the card's idle share over them;
 6c. pose_gn  — the `pose_gn` kernel against the plain route of
                `pose_ba.refine_pose` (`refine_pose_plain`) at the tracker's
                shapes, one pose against 1000 and 2000 edges, 3 rounds:
                rotations within POSE_GN_ROT_TOL rad, translations within
                POSE_GN_TRANS_TOL of their length, inlier sets equal but
                for edges within POSE_GN_GATE_EDGE of the gate, n_inliers
                the inliers' count; the kernel's call ms and device ms, the
                plain route's call ms, device ms a call and device
                operations, and both routes' replay ms as captured programs;
  7. k2       — K2 vs its plain version, equal exactly in d1, d2 and idx, on
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
  8. lc60     — the 60-frame course again with the bench's loop closer
                attached (bundled vocabulary): fps over frames 10-59 and
                ATE; with no closure and no relocalization the ATE must
                equal the session phase's to 1e-4 m;
 8a. bench    — `python -m monocular_slam_tpu_torch.bench` in this process
                at bench.py's sizes (its TUM course exported to and decoded
                from a fresh directory), its JSON line logged: the image
                pipeline tracked >= 54/60 at ATE <= 3 cm, the decoded frames
                equal to the rendered ones bit for bit, lc_ate_cm equal to the
                image ATE to 1e-4 m when the closer fired nothing, the feature
                path >= 38/40, every fps and ba_iters_per_sec finite and > 0,
                K1 once a frame in each image pass (counted from 0 after its
                prewarm), K2 twice and K3's eigh and svd3 in every tracked step
                of each pass and in every replay of the fused step;
  9. loop     — a 112-frame course that revisits its start (max_frames 128),
                with 8 frames of threefry noise after frame 40 (the reference's
                draw from PRNGKey(LOOP_NOISE_KEY)), run through the
                session's programs and again op by op (`run_loop(eager=True)`).
                Each run: at least one closure with i - j >= 40, at least one
                relocalization attempt that launched K2, tracked >= real
                frames - 6, ATE <= 10 cm on the real frames. The two runs:
                equal closures, corrections, reverted and skipped closures,
                relocalization attempts and successes, culled keyframes,
                keyframes and tracked flags, poses within TRAJ_TOL_M. The
                programs' run: host reads (`HostReads`: sync-debug warnings
                plus the programs' reads plus lagged waits) at most
                CLOSURE_READS a closure by where it stopped, 1 plus 1 a
                candidate a relocalization attempt, CULL_READS a
                FrameCulling pass and BOOTSTRAP_READS a bootstrap attempt
                (the op-by-op run's counts printed beside); K2 and svd3 in
                every Sim3 replay, K2 and K3's eigh in every relocalization
                candidate's, K3's eigh and svd3 in every bootstrap
                attempt's; capture seconds, device ms a call and launches by
                program kind, the graph pool's bytes. The programs' run
                against the JAX reference's run of the course
                (tests/fixtures/reference_loop_course.npz): tracked flags of
                the real frames equal but for LOOP_FLAG_FRAC of them, every
                closure on either side partnered within LOOP_PAIR_FRAMES on
                i and j, a corrected/skipped flip only where the reference's
                near-identity gate ratio lies within LOOP_GATE_EDGE of 1; both
                sides' gate drifts reported. Then a direct
                `tracker.relocalize` of the last frame against its
                predecessor;
 10. scale    — the matrix-free solvers at benchmarks/kitti_scale.py's shapes
                through the port's `benchmarks.kitti_scale` (numpy draws): a
                10,000-keyframe drifted Sim3 graph with 100 loop edges
                through `pose_graph.optimize_cg` and the 1000-camera,
                100,000-point, 1.5M-edge problem through
                `cg_ba.bundle_adjust_cg` (10 LM iterations each): finite, chi2
                down at least 10x, the BA under twice its statistical floor
                2 sigma^2 E; the reference driver's rows. Then
                `benchmarks.loop_match_scale` (BoW scores against 10,000
                frames, a 2000x2000 ratio match, 2000 descriptors against
                20,000 map points through K2, whose launches are counted),
                then both routes of global
                BA and of `correct` on the loop phase's final state: the
                CG route's poses (99% of its points) must agree with the
                dense route's to within 10% (25%) of the dense correction;
 11. dist     — the distributed solvers (`parallel/*`). NCCL at world size 1
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
 12. long     — benchmarks/long_run.py's configuration (the port's
                `benchmarks.long_run.run_long`) cut to
                LONG_FRAMES frames, with the pose graph's dense/CG switch
                at the reference's 128 keyframes (the port's default, 512,
                is past this run): fails on a non-finite pose, below 95%
                tracked, below 2 closures, if the closer's pose graph or
                global BA never took its CG route (`LoopCloser.routes`), if
                no feature slot was evicted, unless K1 launched once per
                frame and K2 at least twice in every track call; reports
                ATE, fps, prewarm seconds, each Sim3's seconds, the closure
                stages, the keyframe buckets whose correction programs the
                session still holds, and the programs as the loop phase
                does;
 13. cli      — the port's CLI as a user runs it: the long run's course
                (seed 19, 0.05 rad/frame) rendered on the card for
                CLI_FRAMES frames, written as a TUM directory by
                `render.write_tum` (8-bit PNGs, groundtruth, calib) and
                decoded back by `tum.load(...).load_images_batch` (must equal
                the rendered uint8 frames bit for bit); then `python -m
                monocular_slam_tpu_torch.run --dataset <dir> --loop-closure
                --vocab default --verbose` as a subprocess at the CLI's
                default width (1000 features, max_frames 256, max_points
                30000): exit code 0, tracked >= 95%, ATE <= CLI_MAX_ATE_M, a
                closure with i - j >= 40, the summary's ATE equal to
                `eval.compare` of trajectory.txt
                against groundtruth.txt to 1e-5 m, map.ply readable, K1 one
                launch per frame and K2 at least twice per track call
                (the CLI's own counts). Then the first KITTI_FRAMES frames
                in KITTI layout through `run.main` in-process (tracked >=
                KITTI_MIN_TRACKED) and the synthetic feature route at the
                CLI's defaults (finite ATE). The course stays on disk for
                phase 16.
 14. mesh     — `viz.mesh.estimate_normals` + `poisson_mesh` on the card:
                the cli phase's map.ply points (finite, triangles) and the
                4000-point unit sphere at depth 5 (watertight: no boundary
                edge; mean radius within 5% of 1); seconds of each.
 15. drivers  — the drivers of `monocular_slam_tpu_torch/benchmarks/` and the
                graft entry, each through its `run()` in this process:
                step_profile at its reference's sizes (every value finite
                and > 0; no host sync in any chained loop, by the sync
                debug mode; K1 exactly once in each extraction replay, at
                least TRACK_MIN_LAUNCHES in each track and session-step
                replay), compile_profile against this checkout's `_build/`
                (no nvcc; every cold_s above its steady_ms; the same
                launches per replay, BOOTSTRAP_MIN_LAUNCHES in each
                bootstrap replay), loop_match_scale's direct-index section
                at M = 20,000 (K2's Matches equal the dense route's, K2
                launched in each full_pallas call), scaling at 1 and 2
                ranks (chi2 down; 2 ranks within DIST_GLOO_TOL of 1 rank;
                every PCG step's all-reduce 4 * 6 * F bytes), multihost
                over 2 processes (both report, chi2 down, equal reports),
                train_vocab cut to DRIVER_VOCAB (10^4 words, recall in
                [0, 1]) and the graft entry (its track step launches K2 at
                least twice; `dryrun_multichip(1)` on NCCL); seconds of
                each.
 16. cli_in_process — the cli course again through `run.main` in this
                process, after every other phase (`cli_in_process`): its
                trajectory file equal to the cli subprocess's byte for
                byte, the same tracked count and closures, and the cli
                phase's limits on its own.

Every phase raises on failure. Kernel launch counts are set to 0 just
before each path is driven and read just after (a replay adds the launches
its capture recorded; a capture's warm-up run launches for real) (in `long`, after the
prewarm; in `cli`, the CLI subprocess counts its main loop); the kernels
JSON reports the session's measured run under `launches`, the CLI's
under `launches_cli` and the drivers phase's under `launches_drivers`. The second-to-last line is
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
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from monocular_slam_tpu_torch.benchmarks import device_ops, free_port
from monocular_slam_tpu_torch.benchmarks.kitti_scale import timed_solve

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
TRAJ_TOL_M = 1e-6  # dense-window vs K2-window, and graph vs eager, session trajectories
# the fewest launches of each kernel that one tracked step of an image
# session makes (extraction; the tracker's window and its cross-check;
# triangulation and the PnP refit; the PnP scale and `project_to_so3`)
STEP_MIN_LAUNCHES = {"corner_maps": 1, "hamming_top2": 2, "small_eigh": 1, "svd3": 1,
                     "pose_gn": 2}
K3_SOURCE = "monocular_slam_tpu_torch/csrc/small_eigh.cu"
# K3's kernels by name (`torch.profiler`): eigh takes the per-thread kernel
# for n <= 4 and the warp kernel for n = 5..12
K3_EIGH_THREAD, K3_EIGH_WARP, K3_SVD = ("small_eigh_thread_kernel", "small_eigh_warp_kernel",
                                        "svd3_kernel")
# K3 has no Pallas counterpart: it takes the place of XLA's eigh / svd inside
# the reference's step (`jnp.linalg.eigh` in triangulation and the PnP
# refit, `jnp.linalg.svd` in the SO(3) projection)
K3_REPLACES = "monocular_slam_tpu/geometry/triangulate.py:58"
K3_SVD_REPLACES = "monocular_slam_tpu/geometry/so3.py:179"
K3_FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
K3_TOL = 1e-5  # values relative to the largest; 1 - |<v, v_plain>|; SVD residual
K3_GAP = 1e-3  # eigenvectors compared where the eigengap exceeds this of the largest
# motion-only BA's Gauss-Newton route as one kernel; it takes the place of the
# plain route's ~1,700 device operations a call, the reference's GN round
POSE_GN_SOURCE = "monocular_slam_tpu_torch/csrc/pose_gn.cu"
POSE_GN_REPLACES = "monocular_slam_tpu/optim/pose_ba.py:100"
POSE_GN_EDGES = (1000, 2000)  # edges of one pose: tum1_vga's and kitti_wide's features
POSE_GN_K = (517.306, 516.469, 318.643, 255.314)  # TUM1.yaml's fx, fy, cx, cy
POSE_GN_ROT_TOL = 1e-5  # rad, kernel against the plain route
POSE_GN_TRANS_TOL = 1e-5  # of the translation's length
POSE_GN_GATE_EDGE = 1e-4  # inlier sets may differ only at edges this close to the gate
POSE_GN_FIELDS = ("ms", "device_ms", "plain_ms", "plain_device_ms", "graph_ms",
                  "plain_graph_ms", "plain_device_ops")
# the loop course: the seed-11 orbit, one revolution, with LOOP_NOISE_KEY's
# threefry noise frames after frame BLACKOUT_AFTER; its session's
# configuration. tests/fixtures/reference_loop_course.npz is the JAX
# session's run of it (`python tests/make_reference_fixture.py loop`)
LOOP_FRAMES = 112
LOOP_SEED = 11
LOOP_ANG_STEP = 0.06
BLACKOUT_AFTER = 40
BLACKOUT = 8
LOOP_NOISE_KEY = 40
LOOP_SESSION_SEED = 1
LOOP_FEATURES = 1000
LOOP_MAX_FRAMES = 128
LOOP_MAX_POINTS = 20000
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
# 1.5 x the reference's own ATE on this course from the same seed (4.963 cm,
# `python tests/reference_cli_course.py`), the outcome tolerance of
# tests/test_torch_slice.py; its seeds 1 and 2 reach 4.85 and 2.75 cm
CLI_MAX_ATE_M = 0.0744
CLI_TIMEOUT_S = 480
KITTI_FRAMES = 40
KITTI_MIN_TRACKED = 38
ROOT = Path(__file__).resolve().parent
DRAW_SHAPES = {"pnp": (512, 1000), "bootstrap": (2000, 1000), "sim3": (256, 1000),
               "odd 7x13": (7, 13), "odd 333x777": (333, 777)}
DRAW_SAMPLE = {"pnp": 6, "bootstrap": 8, "sim3": 3}  # sample sizes of the session's RANSACs
DRAW_SEEDS = (0, 3, 12345)
REF_FIXTURE = ROOT / "tests" / "fixtures" / "reference_session_key3.npz"
REF_ROT_TOL = 5e-3  # tests/test_torch_slice.py::_assert_poses_close
REF_TRANS_TOL = (1e-2, 1e-3)  # |dt| <= 1e-2 |t_ref| + 1e-3


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
    from monocular_slam_tpu_torch.ops import fast_score, hamming, pose_gn, small_eigh

    t0 = time.perf_counter()
    mods = (("K1", fast_score), ("K2", hamming), ("K3", small_eigh), ("pose_gn", pose_gn))
    with ThreadPoolExecutor(len(mods)) as ex:  # one nvcc per source, started together
        for f in [ex.submit(mod.load) for _, mod in mods]:
            f.result()
    log(f"[build] K1, K2, K3 and pose_gn built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, mod in mods:
        log(f"[build] {name} {mod.BUILD_INFO['path']} "
            f"(nvcc {mod.BUILD_INFO.get('seconds', 0.0):.2f} s)")
        for line in mod.BUILD_INFO.get("log", "").splitlines():
            log(f"[build]   {line}")


def run_key3_course(eager: bool = False):
    """The port's session over the committed key-3 fixture's frames (the
    reference's course and seed) on the card, through the captured step
    programs unless `eager`, against the fixture's run: (tracked flags,
    keyframes, session key, inlier counts and poses compared; each frame's
    translation difference; each reference translation's length)."""
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    dev = "cuda"
    with np.load(REF_FIXTURE) as f:
        fx = {n: f[n] for n in f.files}
    W, H = (int(v) for v in fx["image_wh"])
    cfg = SlamConfig(max_frames=int(fx["max_frames"]), max_points=int(fx["max_points"]),
                     image_wh=(W, H), frontend=FrontendConfig(n_features=int(fx["n_features"])))
    frames = torch.as_tensor(fx["frames"], device=dev).to(torch.float32)
    sess = SlamSession(cfg, seed=int(fx["seed"]), run_ba=True, device=dev)
    sess._use_graphs = not eager
    sess.prewarm(image=True)
    launches.reset()
    for i in range(frames.shape[0]):
        sess.add_frame(frames[i], fx["k"], i / 30.0)
    poses, valid, _ = sess.trajectory()
    counted = launches.read()
    ref = fx["poses"]
    tracked = np.array([s.tracked for s in sess.stats])
    n_inl = np.array([s.n_inliers for s in sess.stats])
    rot = float(np.abs(poses[:, :, :3] - ref[:, :, :3]).max())
    dt = np.linalg.norm(poses[:, :, 3] - ref[:, :, 3], axis=-1)
    t_len = np.linalg.norm(ref[:, :, 3], axis=-1)
    return {
        "tracked": int(tracked.sum()), "frames": int(len(tracked)),
        "tracked_equal": bool(np.array_equal(tracked, fx["tracked"])),
        "keyframes": sess.keyframes, "keyframes_equal": sess.keyframes == fx["keyframes"].tolist(),
        "key_equal": bool(np.array_equal(sess.key, fx["key"])),
        "n_inliers_max_diff": int(np.abs(n_inl - fx["n_inliers"]).max()),
        "rot_max_diff": rot, "trans_max_diff": float(dt.max()),
        "trans_max_rel_diff": float((dt / np.maximum(t_len, 1e-9)).max()),
        "k1_launches": counted["corner_maps"], "k2_launches": counted["hamming_top2"],
    }, dt, t_len


def phase_draws() -> dict:
    from monocular_slam_tpu_torch.geometry import epipolar
    from monocular_slam_tpu_torch.utils import prng

    dev = "cuda"
    for seed in DRAW_SEEDS:
        key = prng.PRNGKey(seed)
        for name, shape in DRAW_SHAPES.items():
            got = prng.uniform_on(key, shape, dev, minval=1e-6, maxval=1.0).cpu().numpy()
            ref = prng.uniform(key, shape, np.float32, 1e-6, 1.0)
            bits = prng.bits_on(key, shape, dev).cpu().numpy()
            n_bad = int((got != ref).sum() + (bits != prng.random_bits(key, 32, shape)).sum())
            if n_bad:
                raise AssertionError(f"draws: {n_bad} values of seed {seed} at {name} {shape} "
                                     "differ from the numpy generator")
    log(f"[draws] uniform_on and bits_on equal the numpy generator bit for bit at "
        f"{list(DRAW_SHAPES.values())} under seeds {list(DRAW_SEEDS)}")
    key = prng.PRNGKey(5)
    cost = {}
    for name, size in DRAW_SAMPLE.items():
        shape = DRAW_SHAPES[name]
        mask = torch.rand(shape[1], device=dev) > 0.3
        cost[name] = {
            "uniform_ms": time_ms(lambda: prng.uniform_on(key, shape, dev, minval=1e-6)),
            "sample_indices_ms": time_ms(lambda: epipolar._sample_indices(key, shape[0], size,
                                                                          mask)),
        }
    log("[draws] event-timed ms per call: " + json.dumps(cost))

    out, dt, t_len = run_key3_course()
    out["draw_ms"] = cost
    rot, k1, k2 = out["rot_max_diff"], out["k1_launches"], out["k2_launches"]
    log("[draws] reference course on the card: " + json.dumps(out))
    if not (out["tracked_equal"] and out["keyframes_equal"] and out["key_equal"]):
        raise AssertionError("draws: the card's session left the reference's run (tracked flags, "
                             "keyframes or session key differ)")
    if not rot <= REF_ROT_TOL:
        raise AssertionError(f"draws: rotations {rot} apart > {REF_ROT_TOL}")
    if not (dt <= REF_TRANS_TOL[0] * t_len + REF_TRANS_TOL[1]).all():
        raise AssertionError(f"draws: translations {dt.tolist()} apart, beyond "
                             f"{REF_TRANS_TOL[0]} x {t_len.tolist()} + {REF_TRANS_TOL[1]}")
    if k1 != out["frames"] or k2 < 2:
        raise AssertionError(f"draws: K1 launched {k1} times, K2 {k2}")
    return out


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
    from monocular_slam_tpu_torch.ops import fast_score, launches, pyramid

    levels = [x.contiguous() for x in pyramid.build_pyramid(frame.contiguous())]
    g = torch.Generator(device=frame.device).manual_seed(9)
    odd = 40.0 * torch.rand((101, 173), generator=g, device=frame.device)
    odd[20:40, 30:50] += 120.0
    odd[60:63, 100:140] += 90.0

    before = launches.count("corner_maps")
    maps_k = fast_score.corner_maps_levels(levels, 20.0)
    torch.cuda.synchronize()
    if launches.count("corner_maps") != before + 1:
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
                dense_window: bool = False, eager: bool = False):
    """One session over `imgs`, through the captured step programs unless
    `eager` (the same functions op by op on the card). `dense_window`
    forces the tracker's window onto the dense route. The kernels' counts
    are set to 0 after `prewarm` and read after the last frame
    (`launches`), and each tracked step's are read from the counts the card
    kept around it (`SlamSession.step_launches`; `step_min` and `step_max`
    are the fewest and the most of each kernel in any step). With
    `count_syncs`, frames 10-59 run under `set_sync_debug_mode("warn")`:
    host syncs are its warnings plus the session's reads of the mapping
    block's flags and the lagged outcome reads that waited on the card."""
    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam import session as session_mod
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    cfg = SlamConfig(max_frames=64, max_points=20000, image_wh=WH,
                     frontend=FrontendConfig(n_features=1000))
    lc = LoopCloser(vocabulary.load_default(), cfg) if loop_closer else None
    sess = SlamSession(cfg, seed=1, run_ba=True, loop_closer=lc, device="cuda")
    sess._use_graphs = not eager

    def record_sync(message, category, filename, lineno, file=None, line=None):
        """A sync warning, attributed to the innermost frame of the port or
        of this script on the stack. torch's notice that the debug mode is a
        prototype, given once a process when the mode is first set, names
        synchronizing operations but is none."""
        nonlocal syncs
        if "synchroniz" not in str(message) or "prototype" in str(message):
            return
        syncs += 1
        src = f"{filename}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "monocular_slam_tpu_torch" in fr.filename or fr.filename.endswith("chip_smoke.py"):
                src = f"{fr.filename.split('/')[-1]}:{fr.lineno}"
                break
        sync_src[src] = sync_src.get(src, 0) + 1

    skip = 10
    syncs = 0
    sync_src: dict[str, int] = {}
    t_tail = 0.0
    plain_window = tracker._window_matches
    if dense_window:  # before the captures, which record the route
        tracker._window_matches = functools.partial(plain_window, use_kernel=False)
    try:
        sess.prewarm(image=True)  # builds, and on the graph route the captures, before frame 0
        launches.reset()
        for i in range(len(imgs)):
            if i == skip:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flags0, waits0 = sess.flag_reads, session_mod.FrameStats.waits
            if count_syncs and i >= skip:
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = record_sync
                    torch.cuda.set_sync_debug_mode("warn")
                    sess.add_frame(imgs[i], k, i / 30.0)
                    torch.cuda.set_sync_debug_mode("default")
            else:
                sess.add_frame(imgs[i], k, i / 30.0)
        flag_reads = sess.flag_reads - flags0
        waits = session_mod.FrameStats.waits - waits0
        torch.cuda.synchronize()
        t_tail = time.perf_counter() - t0
        counted = launches.read()
    finally:
        tracker._window_matches = plain_window
    steps = sess.step_launches
    poses, valid, _ = sess.trajectory()
    if not np.isfinite(poses[valid]).all():
        raise AssertionError("non-finite poses")
    r = ate_mod.ate(poses[valid], poses_gt[valid])
    out = {} if lc is None else {
        "closures": len(lc.closures), "reloc_attempts": sess.reloc_attempts,
        "culled_keyframes": len(sess._kf_culled),
    }
    n_tail = len(imgs) - skip
    return out | {
        "tracked": int(valid.sum()), "ate_m": r.rmse,
        "fps_10_59": n_tail / t_tail,
        "syncs_per_frame": (syncs + flag_reads + waits) / n_tail if count_syncs else None,
        "debug_mode_syncs_per_frame": syncs / n_tail if count_syncs else None,
        "flag_reads_per_frame": flag_reads / n_tail, "lagged_waits_per_frame": waits / n_tail,
        "sync_sources": dict(sorted(sync_src.items(), key=lambda kv: -kv[1])[:10]),
        "n_map_points": sess.n_map_points,
        "keyframes": sess.keyframes,
        "launches": counted, "track_calls": len(steps),
        "step_min": {n: min((c[n] for c in steps), default=0) for n in launches.KERNELS},
        "step_max": {n: max((c[n] for c in steps), default=0) for n in launches.KERNELS},
        "capture_s": sum(sess.capture_s.values()), "programs": len(sess.capture_s),
        "poses": poses, "valid": valid,
        "tracked_flags": [bool(s.tracked) for s in sess.stats],
    }


def phase_session() -> dict:
    from monocular_slam_tpu_torch.datasets import render

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
        f"{warm['syncs_per_frame']:.2f}, fewest launches in a tracked step {warm['step_min']}")
    log("[session] host syncs by source over frames 10-59: " + json.dumps(warm["sync_sources"]))

    out = run_session(imgs, poses_gt, k, count_syncs=False)
    counted, step_min = out["launches"], out["step_min"]
    k1_launches, k2_launches = counted["corner_maps"], counted["hamming_top2"]
    k3_launches, k3_svd_launches = counted["small_eigh"], counted["svd3"]
    valid = out["valid"]
    same_valid = bool((out["valid"] == warm["valid"]).all())
    v = out["valid"] & warm["valid"]
    traj_diff = float(np.abs(out["poses"][v] - warm["poses"][v]).max()) if v.any() else float("inf")
    poses = out.pop("poses")
    keyframes, tracked_flags = out["keyframes"], out.pop("tracked_flags")
    out["keyframes"] = len(keyframes)
    del out["valid"], warm["poses"], warm["valid"], out["sync_sources"]
    out["syncs_per_frame"] = warm["syncs_per_frame"]
    out["fps_10_59_dense_window"] = warm["fps_10_59"]
    out["k1_launches"], out["k2_launches"] = k1_launches, k2_launches
    out["max_pose_diff_vs_dense_window"] = traj_diff
    log("[session] " + json.dumps(out))
    log(f"[session] tracked {out['tracked']}/{N_FRAMES}, ATE {out['ate_m'] * 100:.3f} cm, "
        f"{out['fps_10_59']:.2f} fps over frames 10-59 (dense window {warm['fps_10_59']:.2f}), "
        f"K1 launches {k1_launches}, K2 launches {k2_launches} in {out['track_calls']} tracked "
        f"steps (at least {step_min['hamming_top2']} each), K3 {k3_launches} eigh and "
        f"{k3_svd_launches} svd3 launches ({step_min['small_eigh']}-"
        f"{out['step_max']['small_eigh']} eigh and {step_min['svd3']}-"
        f"{out['step_max']['svd3']} svd3 a tracked step), pose_gn {counted['pose_gn']} "
        f"({step_min['pose_gn']}-{out['step_max']['pose_gn']} a tracked step), max |pose - "
        f"dense-window pose| {traj_diff:.3g}")
    if out["tracked"] < MIN_TRACKED:
        raise AssertionError(f"tracked {out['tracked']} < {MIN_TRACKED}")
    if not out["ate_m"] <= MAX_ATE_M:
        raise AssertionError(f"ATE {out['ate_m']} m > {MAX_ATE_M} m")
    if not same_valid or not traj_diff <= TRAJ_TOL_M:
        raise AssertionError(f"K2 window run differs from the dense-window run: valid equal "
                             f"{same_valid}, max pose difference {traj_diff}")
    if k1_launches != N_FRAMES:
        raise AssertionError(f"K1 launched {k1_launches} times for {N_FRAMES} frames")
    if out["track_calls"] < MIN_TRACKED - 2 or any(step_min[n] < STEP_MIN_LAUNCHES[n]
                                                  for n in STEP_MIN_LAUNCHES):
        raise AssertionError(f"{out['track_calls']} tracked steps, fewest launches in one "
                             f"{step_min} (want at least {STEP_MIN_LAUNCHES})")
    return {"k1": phase_k1_out, "k1_launches": k1_launches, "k2_launches": k2_launches,
            "imgs": imgs, "poses_gt": poses_gt, "k": k, "ate_m": out["ate_m"], "poses": poses,
            "valid": valid, "keyframes": keyframes, "tracked_flags": tracked_flags,
            "fps_10_59": out["fps_10_59"], "k3_launches": k3_launches,
            "k3_svd_launches": k3_svd_launches, "pose_gn_launches": counted["pose_gn"]}


def _k3_inputs(dev):
    """K3's inputs at the step's shapes, from a seeded numpy generator: the
    (1000, 4, 4) triangulation normal matrices (Gram matrices of four
    row-normalised DLT rows), a (1, 12, 12) PnP refit normal matrix (the
    weighted DLT rows of 150 points at depths 2-8, ill-conditioned as the
    tracker's), and the (1, 3, 3) and (512, 3, 3) rotation blocks that
    `project_to_so3` and the PnP scale take apart (scaled rotations plus
    noise)."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(1000, 4, 4))
    A /= np.linalg.norm(A, axis=-1, keepdims=True)
    tri = np.einsum("nri,nrj->nij", A, A)
    X = np.concatenate([rng.uniform(-2, 2, (150, 2)), rng.uniform(2, 8, (150, 1))], axis=1)
    xy = X[:, :2] / X[:, 2:] + rng.normal(scale=1e-3, size=(150, 2))
    Xh = np.concatenate([X, np.ones((150, 1))], axis=1)
    z = np.zeros_like(Xh)
    rows = np.concatenate([np.concatenate([Xh, z, -xy[:, :1] * Xh], 1),
                           np.concatenate([z, Xh, -xy[:, 1:] * Xh], 1)])
    pnp = (rows.T @ rows)[None]

    def rot(n):
        w = rng.normal(scale=0.5, size=(n, 3))
        th = np.linalg.norm(w, axis=1)[:, None, None]
        W = np.zeros((n, 3, 3))
        W[:, 0, 1], W[:, 0, 2], W[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
        W = W - W.transpose(0, 2, 1)
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W @ W
        return R * rng.uniform(0.5, 3.0, (n, 1, 1)) + rng.normal(scale=1e-2, size=(n, 3, 3))

    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return {"eigh (1000, 4, 4)": f32(tri), "eigh (1, 12, 12)": f32(pnp),
            "svd3 (1, 3, 3)": f32(rot(1)), "svd3 (512, 3, 3)": f32(rot(512))}


def _vec_agreement(V, Vp, w):
    """min |<v, v_plain>| over the eigenvectors whose eigengap exceeds
    K3_GAP of the largest |eigenvalue| (None if no vector qualifies)."""
    w = w.double()
    scale = w.abs().amax(-1, keepdim=True)
    gap = torch.full_like(w, float("inf"))
    d = (w[..., 1:] - w[..., :-1]).abs()
    gap[..., 1:] = torch.minimum(gap[..., 1:], d)
    gap[..., :-1] = torch.minimum(gap[..., :-1], d)
    dots = (V.double() * Vp.double()).sum(-2).abs()
    sel = gap > K3_GAP * scale
    return float(dots[sel].min()) if bool(sel.any()) else None


def phase_k3() -> dict:
    """K3 against its plain version (`torch.linalg.eigh` / `svd`, which is
    also the library call) at the step's shapes: eigenvalues (singular
    values) within K3_TOL of the largest, eigenvectors (singular vectors)
    with |<v, v_plain>| >= 1 - K3_TOL where the gap is clear, each SVD
    reproducing its matrix; event-timed ms per call, profiler device ms,
    and the bound."""
    from monocular_slam_tpu_torch.ops import small_eigh

    dev = "cuda"
    out = {}
    for name, x in _k3_inputs(dev).items():
        n, batch = x.shape[-1], x.numel() // (x.shape[-1] ** 2)
        if name.startswith("eigh"):
            w, V = small_eigh.eigh(x)
            wp, Vp = small_eigh.eigh_plain(x)
            torch.cuda.synchronize()
            val_err = float(((w - wp).abs() / wp.abs().amax(-1, keepdim=True)).max())
            vec = _vec_agreement(V, Vp, wp)
            fn, plain = (lambda x=x: small_eigh.eigh(x)), (lambda x=x: small_eigh.eigh_plain(x))
            kernel = K3_EIGH_THREAD if n <= 4 else K3_EIGH_WARP
            nbytes = batch * (2 * n * n + n) * 4
            ops = batch * 9 * n ** 3  # a dense symmetric eigensolver's ~9 n^3 flops
            recon = None
        else:
            U, S, Vt = small_eigh.svd3(x)
            Up, Sp, Vtp = small_eigh.svd3_plain(x)
            torch.cuda.synchronize()
            val_err = float(((S - Sp).abs() / Sp.amax(-1, keepdim=True)).max())
            vec = min(v for v in (_vec_agreement(U, Up, Sp), _vec_agreement(Vt.mT, Vtp.mT, Sp))
                      if v is not None)
            recon = float(((U * S[..., None, :]) @ Vt - x).abs().max() / x.abs().max())
            fn, plain = (lambda x=x: small_eigh.svd3(x)), (lambda x=x: small_eigh.svd3_plain(x))
            kernel = K3_SVD
            nbytes = batch * (9 + 9 + 3 + 9) * 4  # M read; U, S, Vt written
            ops = batch * 21 * 27  # Golub-Van Loan's ~21 n^3 flops of a full SVD
        ms = time_ms_inference(fn)
        plain_ms = time_ms_inference(plain)
        row = {
            "max_value_rel_err": val_err, "min_vector_dot": vec, "svd_rel_residual": recon,
            "max_abs_err": val_err, "ms": ms, "device_ms": device_ms(fn, kernel),
            "plain_ms": plain_ms, "library_ms": plain_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations",
        }
        out[name] = row
        log(f"[k3] {name}: " + json.dumps(row))
        if not val_err <= K3_TOL:
            raise AssertionError(f"K3 {name}: values {val_err} apart (relative) > {K3_TOL}")
        if vec is None or not vec >= 1 - K3_TOL:
            raise AssertionError(f"K3 {name}: vectors |<v, v_plain>| {vec} < 1 - {K3_TOL}")
        if recon is not None and not recon <= K3_TOL:
            raise AssertionError(f"K3 {name}: U S Vt misses its matrix by {recon}")
    return out


def pose_gn_problem(batch: int, n: int, seed: int, device="cuda"):
    """`batch` motion-only BA problems of n edges each, as the tracker meets
    them, from a seeded torch generator: points 2-8 m ahead of a camera
    with TUM1.yaml's intrinsics, 0.7 px of noise, a fifth of the edges 40
    px off, a tenth masked (weight 0), the start 0.01 rad and 2 cm from the
    truth. (T0 (batch, 3, 4), X (batch, n, 3), uv (batch, n, 2), k (4,),
    w (batch, n)), float32 on `device`."""
    from monocular_slam_tpu_torch.geometry import se3

    g = torch.Generator().manual_seed(seed)
    k = torch.tensor(POSE_GN_K)
    X = torch.rand(batch, n, 3, generator=g) * torch.tensor([4.0, 3.0, 6.0])
    X = X + torch.tensor([-2.0, -1.5, 2.0])
    T = se3.exp(torch.randn(batch, 6, generator=g) * torch.tensor([0.1] * 3 + [0.5] * 3))
    Xc = se3.apply(T[:, None], X)
    uv = torch.stack([k[0] * Xc[..., 0] / Xc[..., 2] + k[2],
                      k[1] * Xc[..., 1] / Xc[..., 2] + k[3]], -1)
    uv = uv + 0.7 * torch.randn(batch, n, 2, generator=g)
    uv[torch.rand(batch, n, generator=g) < 0.2] += 40.0
    w = (torch.rand(batch, n, generator=g) > 0.1).float()
    d = torch.randn(batch, 6, generator=g) * torch.tensor([0.01] * 3 + [0.02] * 3)
    T0 = se3.compose(se3.exp(d), T)
    return tuple(x.contiguous().to(device) for x in (T0, X, uv, k, w))


def pose_gn_agreement(a, b, X, uv, k, gate: float = 5.991) -> dict:
    """How far `a` (the kernel's `PoseBAResult`) lies from `b` (the plain
    route's): the largest rotation angle between their poses (rad), the
    largest translation difference over the plain translation's length,
    the inlier flags that differ, those of them farther than
    POSE_GN_GATE_EDGE from the gate (squared error at the plain pose, in
    float64), whether each n_inliers counts its inliers and the two counts
    differ by no more than the flags, and the chi2s' relative difference."""
    from monocular_slam_tpu_torch.optim import residuals

    Ra, Rb = a.T[..., :3].double(), b.T[..., :3].double()
    fro = (Ra - Rb).flatten(-2).norm(dim=-1)
    rot = 2.0 * torch.asin((fro / (2.0 * 2.0 ** 0.5)).clamp(max=1.0))
    ta, tb = a.T[..., 3].double(), b.T[..., 3].double()
    trans = (ta - tb).norm(dim=-1) / tb.norm(dim=-1).clamp(min=1e-30)
    r = residuals.residual(b.T.double()[..., None, :, :], X.double(), k.double(), uv.double())
    e2 = (r * r).sum(-1)
    diff = a.inliers != b.inliers
    off_gate = diff & ~((e2 - gate).abs() <= POSE_GN_GATE_EDGE)
    counts = bool((a.n_inliers == a.inliers.sum(-1)).all()
                  and ((a.n_inliers - b.n_inliers).abs() <= diff.sum(-1)).all())
    ca, cb = a.chi2.double(), b.chi2.double()
    chi2 = torch.where(ca == cb, 0.0, (ca - cb).abs() / cb.abs().clamp(min=1e-30))
    return {"rot_rad": float(rot.max()), "trans_rel": float(trans.max()),
            "inliers_differ": int(diff.sum()), "inliers_differ_off_gate": int(off_gate.sum()),
            "n_inliers_consistent": counts, "chi2_rel": float(chi2.max())}


def pose_gn_fails(agr: dict) -> list:
    """What in a `pose_gn_agreement` misses the card test's tolerances."""
    fails = []
    if not agr["rot_rad"] <= POSE_GN_ROT_TOL:
        fails.append(f"rotations {agr['rot_rad']} rad apart > {POSE_GN_ROT_TOL}")
    if not agr["trans_rel"] <= POSE_GN_TRANS_TOL:
        fails.append(f"translations {agr['trans_rel']} of their length apart > "
                     f"{POSE_GN_TRANS_TOL}")
    if agr["inliers_differ_off_gate"]:
        fails.append(f"{agr['inliers_differ_off_gate']} inlier flags differ away from the gate")
    if not agr["n_inliers_consistent"]:
        fails.append("n_inliers does not count the inliers")
    return fails


def device_ms_per_call(fn, n: int = 5) -> float:
    """Device ms of every operation one call of fn puts on the card, the
    mean over n calls from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / n / 1e3


def phase_pose_gn() -> dict:
    """`pose_gn` against the plain route (`refine_pose_plain`) on the card
    with POSE_GN_EDGES edges, 3 rounds as the tracker's local-map refine:
    `pose_gn_agreement` within the card test's tolerances; the kernel's
    event-timed call and profiler device ms, the plain route's call ms,
    device ms a call and device operations, and both captured as programs,
    the median event-timed replay."""
    from monocular_slam_tpu_torch.optim import pose_ba
    from monocular_slam_tpu_torch.utils import graph

    out = {}
    for n in POSE_GN_EDGES:
        args = tuple(x[0] if x.dim() > 1 else x for x in pose_gn_problem(1, n, seed=n))

        def kern(args=args):
            return pose_ba.refine_pose(*args, n_rounds=3, solver="gn")

        def plain(args=args):
            return pose_ba.refine_pose_plain(*args, n_rounds=3, solver="gn")

        a, b = kern(), plain()
        torch.cuda.synchronize()
        agr = pose_gn_agreement(a, b, *args[1:4])
        with torch.inference_mode():
            progs = [graph.Program(fn, stream=torch.cuda.Stream()) for fn in (kern, plain)]
        name = f"(1, {n})"
        row = {**agr, "ms": time_ms_inference(kern), "device_ms": device_ms(kern, "pose_gn_kernel"),
               "plain_ms": time_ms_inference(plain), "plain_device_ms": device_ms_per_call(plain),
               "graph_ms": time_ms(progs[0].replay), "plain_graph_ms": time_ms(progs[1].replay),
               "plain_device_ops": device_ops(plain, "cuda"),
               "n_inliers": int(a.n_inliers), "plain_n_inliers": int(b.n_inliers)}
        del progs
        out[name] = row
        log(f"[pose_gn] {name}: " + json.dumps(row))
        fails = pose_gn_fails(agr)
        if fails:
            raise AssertionError(f"pose_gn {name}: " + "; ".join(fails))
    return out


def phase_program(sess_out) -> dict:
    """The step program on the card: the 60-frame course through the
    captured programs (with host syncs counted over frames 10-59) against
    the same functions run op by op on the card (`_use_graphs` cleared):
    equal tracked flags and keyframes, poses within TRAJ_TOL_M; fps of
    both; the programs' capture seconds and graph-pool memory; a profile
    of ten tracked frames' replays (device operations and device ms a
    frame, the card's idle share, and the kernels by name: K1, K2 twice,
    K3's eigh and svd3 in every frame)."""
    from torch.profiler import ProfilerActivity, profile

    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, poses_gt, k = sess_out["imgs"], sess_out["poses_gt"], sess_out["k"]
    graph_run = run_session(imgs, poses_gt, k, count_syncs=True)
    eager_run = run_session(imgs, poses_gt, k, count_syncs=True, eager=True)
    same_flags = graph_run["tracked_flags"] == eager_run["tracked_flags"]
    same_kf = graph_run["keyframes"] == eager_run["keyframes"]
    v = graph_run["valid"] & eager_run["valid"]
    diff = float(np.abs(graph_run["poses"][v] - eager_run["poses"][v]).max())

    # captures and pool memory, then ten tracked frames' replays profiled
    cfg = SlamConfig(max_frames=64, max_points=20000, image_wh=WH,
                     frontend=FrontendConfig(n_features=1000))
    sess = SlamSession(cfg, seed=1, run_ba=True, device="cuda")
    prewarm_s = sess.prewarm(image=True)
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == tuple(sess._pool))

    def profile_ops(prof):
        """(device operations, their device ms, counts and device ms of the
        kernels by name)."""
        names, tag_ms, n, us = {}, {}, 0, 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host events (their device time is their children's)
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            n += e.count
            us += t
            for tag in ("corner_maps_levels_kernel", "hamming_top2_kernel", K3_EIGH_THREAD,
                        K3_EIGH_WARP, K3_SVD, "pose_gn_kernel"):
                if tag in e.key:
                    names[tag] = names.get(tag, 0) + e.count
                    tag_ms[tag] = tag_ms.get(tag, 0.0) + t / 1e3
        return n, us / 1e3, names, tag_ms

    for i in range(13):
        sess.add_frame(imgs[i], k, i / 30.0)
    torch.cuda.synchronize()
    # ten steady tracked frames profiled; the card's idle share is 1 - device
    # busy / wall. The host waits before the first frame: a trace that started
    # with the frame once lost the frame's first ~115 device operations, K1
    # among them.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        t0 = time.perf_counter()
        for i in range(13, 23):
            sess.add_frame(imgs[i], k, i / 30.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_ops, busy_ms, names, names_ms = profile_ops(prof)
    k3_ms = sum(names_ms.get(t, 0.0) for t in (K3_EIGH_THREAD, K3_EIGH_WARP, K3_SVD)) / 10
    out = {
        "graph": {n: graph_run[n] for n in ("tracked", "ate_m", "fps_10_59", "syncs_per_frame",
                                            "debug_mode_syncs_per_frame", "flag_reads_per_frame",
                                            "lagged_waits_per_frame", "sync_sources", "capture_s",
                                            "programs")},
        "eager": {n: eager_run[n] for n in ("tracked", "ate_m", "fps_10_59", "syncs_per_frame",
                                            "sync_sources")},
        "tracked_equal": same_flags, "keyframes_equal": same_kf, "max_pose_diff_m": diff,
        "prewarm_s": prewarm_s, "capture_s": {"/".join(str(p) for p in key[:3]): s
                                              for key, s in sess.capture_s.items()},
        "graph_pool_bytes": pool_bytes,
        "device_ops_per_frame_13_22": n_ops / 10, "device_ms_per_frame_13_22": busy_ms / 10,
        "wall_ms_per_frame_13_22": wall_ms / 10, "idle_share_frames_13_22": 1.0 - busy_ms / wall_ms,
        "kernels_by_name_13_22": names,
        "kernel_ms_per_frame_13_22": {t: ms / 10 for t, ms in names_ms.items()},
        "k3_ms_per_frame_13_22": k3_ms,
        # the profiler slows the host: the same device time over the unprofiled
        # run's wall time per frame (frames 10-59)
        "idle_share_unprofiled": 1.0 - (busy_ms / 10) * graph_run["fps_10_59"] / 1e3,
    }
    log("[program] " + json.dumps(out))
    log(f"[program] graph route: {graph_run['tracked']}/{N_FRAMES} tracked, ATE "
        f"{graph_run['ate_m'] * 100:.3f} cm, {graph_run['fps_10_59']:.2f} fps, "
        f"{graph_run['syncs_per_frame']:.2f} host syncs per frame; eager route on the card: "
        f"{eager_run['fps_10_59']:.2f} fps, {eager_run['syncs_per_frame']:.2f} host syncs per "
        f"frame; max |pose_graph - pose_eager| {diff:.3g} m; "
        f"{n_ops / 10:.1f} device operations ({busy_ms / 10:.2f} ms, K3 {k3_ms:.4f} ms) a tracked "
        f"frame over frames 13-22; the card idle "
        f"{100 * out['idle_share_frames_13_22']:.1f}% over them (profiled), "
        f"{100 * out['idle_share_unprofiled']:.1f}% against the unprofiled wall")
    fails = []
    if graph_run["tracked"] < MIN_TRACKED or not graph_run["ate_m"] <= MAX_ATE_M:
        fails.append(f"tracked {graph_run['tracked']}, ATE {graph_run['ate_m']}")
    if not (same_flags and same_kf and diff <= TRAJ_TOL_M):
        fails.append(f"graph vs eager: flags equal {same_flags}, keyframes equal {same_kf}, "
                     f"max pose difference {diff}")
    if not graph_run["syncs_per_frame"] <= 1.0:
        fails.append(f"{graph_run['syncs_per_frame']} host syncs per frame > 1")
    if (names.get("corner_maps_levels_kernel", 0) < 10 or names.get("hamming_top2_kernel", 0) < 20
            or names.get(K3_EIGH_THREAD, 0) + names.get(K3_EIGH_WARP, 0) < 10
            or names.get(K3_SVD, 0) < 10 or names.get("pose_gn_kernel", 0) < 20):
        fails.append(f"frames 13-22's profiled replays ran {names}, not K1, K2 twice, eigh, "
                     f"svd3 and pose_gn twice in each frame")
    if fails:
        raise AssertionError("program: " + "; ".join(fails))
    return out


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
    out = run_session(sess_out["imgs"], sess_out["poses_gt"], sess_out["k"], count_syncs=False,
                      loop_closer=True)
    out["k1_launches"], out["k2_launches"] = (out["launches"]["corner_maps"],
                                              out["launches"]["hamming_top2"])
    del out["sync_sources"], out["poses"], out["valid"], out["tracked_flags"]
    out["keyframes"] = len(out["keyframes"])
    log("[lc60] " + json.dumps(out))
    log(f"[lc60] tracked {out['tracked']}/{N_FRAMES}, ATE {out['ate_m'] * 100:.3f} cm "
        f"(without the closer {sess_out['ate_m'] * 100:.3f} cm), {out['fps_10_59']:.2f} fps over "
        f"frames 10-59, closures {out['closures']}, relocalization attempts {out['reloc_attempts']}")
    if out["tracked"] < MIN_TRACKED or not out["ate_m"] <= MAX_ATE_M:
        raise AssertionError(f"lc60: tracked {out['tracked']}, ATE {out['ate_m']}")
    if out["k1_launches"] != N_FRAMES:
        raise AssertionError(f"lc60: K1 launched {out['k1_launches']} times for {N_FRAMES} "
                             f"frames")
    if any(out["step_min"][n] < STEP_MIN_LAUNCHES[n] for n in STEP_MIN_LAUNCHES):
        raise AssertionError(f"lc60: fewest launches in a tracked step {out['step_min']}")
    if out["closures"] == 0 and out["reloc_attempts"] == 0:
        if abs(out["ate_m"] - sess_out["ate_m"]) > 1e-4:
            raise AssertionError(f"lc60: nothing fired but ATE {out['ate_m']} != {sess_out['ate_m']}")
    return out


# the bench phase's limits (`python -m monocular_slam_tpu_torch.bench` at bench.py's sizes)
BENCH_MIN_TRACKED = 54  # of 60
BENCH_MIN_KERNEL_TRACKED = 38  # of the feature path's 40
BENCH_LC_ATE_TOL_M = 1e-4  # lc_ate_cm vs the image ATE when no closure fired (lc60's rule)
BENCH_FUSED_MIN = {"hamming_top2": 2, "small_eigh": 1, "svd3": 1}  # a fused-step replay


def phase_bench() -> dict:
    """The port's flagship benchmark in this process at bench.py's sizes,
    its TUM course exported to (and decoded from) a fresh directory: its
    JSON line logged, then held to the session's limits, the decoder to
    the rendered frames bit for bit, K1 once a frame in each image pass,
    K2, K3's eigh and svd3 in every tracked step of each pass and in every
    replay of the fused step."""
    from monocular_slam_tpu_torch import bench
    from monocular_slam_tpu_torch.datasets import render

    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        out, det = bench.run("cuda", root=work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("[bench] " + json.dumps(out))
    imgs, _, _ = render.render_sequence(seed=bench.COURSE_SEED, n_frames=N_FRAMES, wh=WH,
                                        device="cuda")
    same = bool(np.array_equal(imgs.cpu().numpy(), det["decoded"]))
    n_rep, fl = det["n_rep"], det["fused_launches"]
    summary = {"passes": det["passes"], "decoded_equal_rendered": same,
               "lc_closures": det["lc_closures"], "lc_reloc_attempts": det["lc_reloc_attempts"],
               "fused_launches_per_replay": {n: v / n_rep for n, v in fl.items()},
               "fused_links_tracked": sum(x[0] for x in det["fused_links"])}
    log("[bench] " + json.dumps(summary))
    fails = []
    tracked, n = (int(x) for x in out["image_pipeline_tracked"].split("/"))
    if tracked < BENCH_MIN_TRACKED or not out["image_pipeline_ate_cm"] / 100 <= MAX_ATE_M:
        fails.append(f"image pipeline tracked {tracked}/{n}, ATE {out['image_pipeline_ate_cm']} cm")
    if not same:
        fails.append("the decoded frames differ from the rendered ones")
    if not det["lc_closures"] and not det["lc_reloc_attempts"]:
        if not abs(out["lc_ate_cm"] - out["image_pipeline_ate_cm"]) / 100 <= BENCH_LC_ATE_TOL_M:
            fails.append(f"nothing fired but lc_ate_cm {out['lc_ate_cm']} != "
                         f"{out['image_pipeline_ate_cm']}")
    if int(out["kernel_tracked"].split("/")[0]) < BENCH_MIN_KERNEL_TRACKED:
        fails.append(f"feature path tracked {out['kernel_tracked']}")
    for name in ("value", "lc_fps", "ingest_overlapped_fps", "kernel_fps", "ba_iters_per_sec"):
        if not (np.isfinite(out[name]) and out[name] > 0):
            fails.append(f"{name} {out[name]}")
    for name, ps in det["passes"].items():
        if ps["k1"] != ps["frames"]:
            fails.append(f"{name} pass: K1 launched {ps['k1']} times for {ps['frames']} frames")
        if ps["track_calls"] < BENCH_MIN_TRACKED - 2 or any(
                ps["step_min"][m] < STEP_MIN_LAUNCHES[m] for m in STEP_MIN_LAUNCHES):
            fails.append(f"{name} pass: {ps['track_calls']} tracked steps, fewest launches in one "
                         f"{ps['step_min']}")
    if any(fl[m] < v * n_rep for m, v in BENCH_FUSED_MIN.items()):
        fails.append(f"the fused step's {n_rep} replays launched {fl}")
    if fails:
        raise AssertionError("bench: " + "; ".join(fails))
    return {"json": out, "fused_launches": fl, **summary}


# the drivers phase: the fewest launches of each kernel a replay of a
# stage that tracks (the tracker's window and its cross-check;
# triangulation and the PnP refit; the PnP scale), and of the bootstrap
TRACK_MIN_LAUNCHES = {"hamming_top2": 2, "small_eigh": 1, "svd3": 1}
BOOTSTRAP_MIN_LAUNCHES = {"small_eigh": 1, "svd3": 1}
DRIVER_SHARDS = (1, 2)
DRIVER_VOCAB = dict(train_scenes=2, frames_per_scene=6, augs=1, eval_scenes=1)
DRIVER_DIRECT_INDEX_M = (20000,)


def _per_replay_fails(name, launches, replays, minimum, exact=()) -> list:
    """A stage's launches over `replays` replays against the fewest a
    replay must make (`exact`: kernels that must launch exactly so)."""
    fails = [f"{name}: {k} launched {launches[k]} times in {replays} replays"
             for k, v in minimum.items() if launches[k] < v * replays]
    fails += [f"{name}: {k} launched {launches[k]} times in {replays} replays, want {v} a replay"
              for k, v in exact if launches[k] != v * replays]
    return fails


def phase_drivers() -> dict:
    """Each driver ported in this slice, in process through its `run()`:
    step_profile and compile_profile (against this checkout's `_build/`,
    so no nvcc runs) with the kernels' launches in the replays of each
    stage, loop_match_scale's direct-index section at M = 20,000, scaling
    at 1 and 2 ranks, multihost over 2 processes, a reduced train_vocab and
    the graft entry."""
    from monocular_slam_tpu_torch import graft_entry
    from monocular_slam_tpu_torch.benchmarks import (compile_profile, loop_match_scale,
                                                     multihost, scaling, step_profile,
                                                     train_vocab)
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.utils import cuda_build

    fails, seconds, counted = [], {}, {k: 0 for k in launches.KERNELS}

    def add(c):
        for k in counted:
            counted[k] += c[k]

    t = time.perf_counter()
    det: dict = {}
    sp = step_profile.run("cuda", details=det)
    seconds["step_profile"] = time.perf_counter() - t
    log("[drivers] step_profile " + json.dumps(sp))
    stages = {n: {"replays": r["replays"], "syncs": r["syncs"], "launches": r["launches"]}
              for n, r in det.items() if isinstance(r, dict) and "replays" in r}
    log("[drivers] step_profile stages " + json.dumps(stages) + ", session step branch "
        f"(fuse, BA, cull) {det['session_step_branch']}")
    fails += [f"step_profile: {k} = {v}" for k, v in sp.items()
              if k != "device" and not (np.isfinite(v) and v > 0)]
    fails += [f"step_profile: {n}'s chained loop made {r['syncs']} host syncs"
              for n, r in stages.items() if r["syncs"]]
    fails += _per_replay_fails("step_profile extract", stages["extract"]["launches"],
                               stages["extract"]["replays"], {}, (("corner_maps", 1),))
    for n in ("track", "session_step"):
        fails += _per_replay_fails(f"step_profile {n}", stages[n]["launches"],
                                   stages[n]["replays"], TRACK_MIN_LAUNCHES)
    for r in stages.values():
        add(r["launches"])

    t = time.perf_counter()
    det = {}
    cp = compile_profile.run("cuda", build_dir=str(cuda_build.BUILD_DIR), details=det)
    seconds["compile_profile"] = time.perf_counter() - t
    log("[drivers] compile_profile " + json.dumps(cp))
    progs = {n: {k: det[n][k] for k in ("replays", "launches", "nodes")} for n in cp["programs"]}
    log("[drivers] compile_profile replays " + json.dumps(progs))
    fails += [f"compile_profile {n}: cold {r['cold_s']} s <= steady {r['steady_ms']} ms"
              for n, r in cp["programs"].items() if not r["cold_s"] > r["steady_ms"] / 1e3]
    fails += _per_replay_fails("compile_profile extract_640x480",
                               progs["extract_640x480"]["launches"],
                               progs["extract_640x480"]["replays"], {}, (("corner_maps", 1),))
    for n, minimum in (("track", TRACK_MIN_LAUNCHES), ("session_step", TRACK_MIN_LAUNCHES),
                       ("bootstrap", BOOTSTRAP_MIN_LAUNCHES)):
        fails += _per_replay_fails(f"compile_profile {n}", progs[n]["launches"],
                                   progs[n]["replays"], minimum)
    for r in progs.values():
        add(r["launches"])

    t = time.perf_counter()
    det = {}
    di = loop_match_scale.direct_index(maps=DRIVER_DIRECT_INDEX_M, device="cuda", details=det)
    seconds["loop_match_scale_direct_index"] = time.perf_counter() - t
    log("[drivers] loop_match_scale " + json.dumps(di) + " " + json.dumps(det))
    for M, r in det.items():
        if not r["kernel_equals_dense"]:
            fails.append(f"loop_match_scale: K2's Matches differ from the dense route's at M={M}")
        if r["k2_launches_a_call"] < 1:
            fails.append(f"loop_match_scale: a full_pallas call launched K2 "
                         f"{r['k2_launches_a_call']} times at M={M}")
        counted["hamming_top2"] += r["k2_launches_a_call"]

    t = time.perf_counter()
    det = {}
    sc = scaling.run(shards=DRIVER_SHARDS, device="cuda", details=det)
    seconds["scaling"] = time.perf_counter() - t
    log("[drivers] scaling " + json.dumps(sc))
    F = sc["frames"]
    for solver in scaling.SOLVERS:
        one = det[DRIVER_SHARDS[0]][0][solver]
        for s in DRIVER_SHARDS:
            for r in det[s]:
                res = r[solver]
                if not float(res["chi2_history"][-1]) < res["chi2_initial"]:
                    fails.append(f"scaling {solver} at {s} ranks: chi2 {res['chi2_initial']} -> "
                                 f"{float(res['chi2_history'][-1])}")
                rel = float(np.abs(res["chi2_history"] - one["chi2_history"]).max()
                            / np.abs(one["chi2_history"]).max())
                pose = float(np.abs(res["poses"] - one["poses"]).max())
                log(f"[drivers] scaling {solver}, {s} ranks, rank {r['rank']}: chi2 history "
                    f"{rel:.3g} from 1 rank, poses {pose:.3g}")
                if rel > DIST_GLOO_TOL["cg"][0] or pose > DIST_GLOO_TOL["cg"][1]:
                    fails.append(f"scaling {solver} at {s} ranks: chi2 {rel:.3g}, poses "
                                 f"{pose:.3g} from 1 rank")
                if solver == "cg":
                    got = set(scaling.pcg_bytes(res["collectives"], F))
                    if got != {scaling.cg_comm_bytes_per_iter(F)}:
                        fails.append(f"scaling cg at {s} ranks: bytes a PCG step {got}, want "
                                     f"{scaling.cg_comm_bytes_per_iter(F)}")

    t = time.perf_counter()
    mh = multihost.run(2, device="cuda", timeout=DIST_RANK_TIMEOUT_S)
    seconds["multihost"] = time.perf_counter() - t
    log("[drivers] multihost " + json.dumps(mh))
    reps = mh["reports"]
    if not mh["ok"] or len(reps) != 2:
        fails.append(f"multihost: {mh}")
    else:
        for solver in ("dense", "cg"):
            a, b = (r[solver] for r in reps)
            if not (a["chi2_final"] < a["chi2_initial"] and b["chi2_final"] < b["chi2_initial"]):
                fails.append(f"multihost {solver}: chi2 did not go down: {a}, {b}")
            if (a["chi2_initial"], a["chi2_final"]) != (b["chi2_initial"], b["chi2_final"]):
                fails.append(f"multihost {solver}: the two reports differ: {a}, {b}")

    t = time.perf_counter()
    log("[drivers] train_vocab reduced from the reference's 12 train scenes x 24 frames, 2 "
        "augmentations and 4 eval scenes to " + json.dumps(DRIVER_VOCAB))
    tv = train_vocab.run(device="cuda", **DRIVER_VOCAB)
    seconds["train_vocab"] = time.perf_counter() - t
    log("[drivers] train_vocab " + json.dumps(tv))
    r = tv["results"]["10k"]
    if r["words"] != 10**4 or not 0.0 <= r["top1_recall_shifted"] <= 1.0:
        fails.append(f"train_vocab: {r}")

    t = time.perf_counter()
    fn, args = graft_entry.entry("cuda")
    torch.cuda.synchronize()
    launches.reset()
    poses, n_inl = fn(*args)
    torch.cuda.synchronize()
    g = launches.read()
    add(g)
    dry = graft_entry.dryrun_multichip(1, "cuda")
    seconds["graft_entry"] = time.perf_counter() - t
    log(f"[drivers] graft entry: track of frame 3, {int(n_inl)} PnP inliers, launches {g}; "
        f"dryrun_multichip(1) on {dry[0]['backend']}: chi2 {dry[0]['chi2_initial']} -> "
        f"{float(dry[0]['chi2_history'][-1])}")
    if g["hamming_top2"] < 2 or not torch.isfinite(poses).all():
        fails.append(f"graft entry: launches {g}")
    if dry[0]["backend"] != "nccl":
        fails.append(f"graft entry: dryrun_multichip(1) ran on {dry[0]['backend']}")
    log("[drivers] seconds " + json.dumps(seconds) + ", launches " + json.dumps(counted))
    if fails:
        raise AssertionError("drivers: " + "; ".join(fails))
    return {"launches": counted, "seconds": seconds}


def loop_noise(dev) -> torch.Tensor:
    """The loop course's BLACKOUT noise frames on `dev`: floor(255 u), u the
    float32 threefry uniforms of `PRNGKey(LOOP_NOISE_KEY)` (the reference's
    `jax.random.uniform` draw)."""
    from monocular_slam_tpu_torch.utils import prng

    return torch.floor(255.0 * prng.uniform_on(prng.PRNGKey(LOOP_NOISE_KEY),
                                               (BLACKOUT, WH[1], WH[0]), torch.device(dev)))


def _loop_frames(dev):
    """The revisiting course with a blackout: real frames 0..40, 8 frames of
    uniform noise, then real frames 41..111. The noise is the reference's
    draw, floor(255 u) with u the float32 threefry uniforms of
    `PRNGKey(LOOP_NOISE_KEY)`, made on `dev`. Returns (frames, real_ids,
    poses_gt, k)."""
    from monocular_slam_tpu_torch.datasets import render

    imgs, poses_gt, k = render.render_sequence(seed=LOOP_SEED, n_frames=LOOP_FRAMES, wh=WH,
                                               ang_step=LOOP_ANG_STEP, device=dev)
    noise = loop_noise(dev)
    cut = BLACKOUT_AFTER + 1
    frames = torch.cat([imgs[:cut], noise, imgs[cut:]])
    real = list(range(cut)) + list(range(cut + BLACKOUT, LOOP_FRAMES + BLACKOUT))
    return frames, real, poses_gt, k


# host reads a program-driven event may make: (kind) -> limit, or, for a
# relocalization attempt, 1 plus 1 a candidate
CLOSURE_READS = {"sim3": 1, "valid": 2, "correction": 5}  # by where the closure stopped
BOOTSTRAP_READS = 1
CULL_READS = 1


def program_summary(sess) -> dict:
    """A session's programs outside the tracked step: calls, device ms
    (events around each call) and kernel launches by program kind, the
    capture seconds of each such program, and the graph pool's bytes."""
    from monocular_slam_tpu_torch.ops import launches

    by = {}
    for c in sess.program_calls:
        d = by.setdefault(c["kind"], {"calls": 0, "device_ms": 0.0,
                                      "launches": dict.fromkeys(launches.KERNELS, 0)})
        d["calls"] += 1
        d["device_ms"] += c["ms"]
        for n, v in c["launches"].items():
            d["launches"][n] += v
    for d in by.values():
        d["ms_per_call"] = d["device_ms"] / d["calls"]
    by_program = {}
    for c in sess.program_calls:
        name = "/".join(str(p) for p in c["key"] if not _is_object_id(p))
        calls, ms = by_program.get(name, (0, 0.0))
        by_program[name] = (calls + 1, ms + c["ms"])
    pool = 0
    if sess._pool is not None:
        pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(sess._pool))
    return {"by_kind": by, "graph_pool_bytes": pool, "programs": len(sess.capture_s),
            "ms_per_call_by_program": {n: ms / calls for n, (calls, ms) in by_program.items()},
            "capture_s": {"/".join(str(p) for p in key if not _is_object_id(p)): t
                          for key, t in sess.capture_s.items() if key[0] not in ("track", "map")}}


def program_nodes(sess) -> dict:
    """Graph nodes of each program outside the tracked step, counted as the
    device operations (kernels, copies, memsets) one replay puts on the
    card (`torch.profiler`), after the run; the replays write the session's
    state and database, which are put back."""
    saved = [x.clone() for x in sess._state]
    db = sess.loop_closer._db.clone() if sess.loop_closer is not None else None
    out = {}
    for key, prog in sess._graphs.programs.items():
        if key[0] not in ("track", "map"):
            name = "/".join(str(p) for p in key if not _is_object_id(p))
            out[name] = device_ops(prog.replay, "cuda")
    for buf, x in zip(sess._state, saved):
        buf.copy_(x)
    if db is not None:
        sess.loop_closer._db.copy_(db)
    return out


def _is_object_id(p) -> bool:
    """A program key's `id()` of its closer (left out of printed names)."""
    return isinstance(p, int) and not isinstance(p, bool) and p > 2**20


class HostReads:
    """Host reads inside the session's program-driven events, counted as the
    program phase counts them: `set_sync_debug_mode` warnings (outside the
    programs' captures, which are one-time builds and counted apart) plus
    the programs' own reads (`graph.Readback`) plus lagged outcome reads
    that waited. `wrap(owner, attr, kind)` records one event per call."""

    def __init__(self):
        from monocular_slam_tpu_torch.utils import graph

        self.events: list[dict] = []
        self.capture_syncs = 0
        self._building = 0
        self._undo = []
        build = graph.Program.__init__

        def building(prog, *a, **kw):
            self._building += 1
            try:
                build(prog, *a, **kw)
            finally:
                self._building -= 1

        graph.Program.__init__ = building
        self._undo.append((graph.Program, "__init__", build))

    def wrap(self, owner, attr: str, kind: str, info=None):
        from monocular_slam_tpu_torch.slam import session as session_mod
        from monocular_slam_tpu_torch.utils import graph

        orig = getattr(owner, attr)

        def counted(*a, **kw):
            syncs = 0

            def record(message, category, filename, lineno, file=None, line=None):
                nonlocal syncs
                if "synchroniz" not in str(message) or "prototype" in str(message):
                    return
                if self._building:
                    self.capture_syncs += 1
                else:
                    syncs += 1

            r0, w0 = graph.Readback.reads, session_mod.FrameStats.waits
            cuda = torch.cuda.is_available()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                if cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = orig(*a, **kw)
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("default")
            ev = {"kind": kind, "syncs": syncs, "reads": graph.Readback.reads - r0,
                  "waits": session_mod.FrameStats.waits - w0}
            ev["total"] = ev["syncs"] + ev["reads"] + ev["waits"]
            if info is not None:
                ev.update(info(a, out))
            self.events.append(ev)
            return out

        setattr(owner, attr, counted)
        self._undo.append((owner, attr, orig))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def by_kind(self) -> dict:
        out = {}
        for ev in self.events:
            d = out.setdefault(ev["kind"], {"events": 0, "max_total": 0, "sum_total": 0})
            d["events"] += 1
            d["max_total"] = max(d["max_total"], ev["total"])
            d["sum_total"] += ev["total"]
        return out


def run_loop(frames, real, poses_gt, k, voc, label: str, eager: bool = False) -> dict:
    """The loop course through the session's programs, or with `eager` the
    same functions op by op on the card. Host reads are counted per
    program-driven event (`HostReads`): each closure (and where it stopped),
    relocalization attempt (and its candidates), FrameCulling dispatch and
    application, and bootstrap attempt."""
    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    dev = frames.device
    cfg = SlamConfig(max_frames=LOOP_MAX_FRAMES, max_points=LOOP_MAX_POINTS, image_wh=WH,
                     frontend=FrontendConfig(n_features=LOOP_FEATURES))
    lc = LoopCloser(voc, cfg, device=dev)
    sess = SlamSession(cfg, seed=LOOP_SESSION_SEED, run_ba=True, loop_closer=lc, device=dev)
    sess._use_graphs = not eager  # the same functions op by op with `eager`
    sess.prewarm(image=True)
    reads = HostReads()

    seen = {"routes": 0, "valid": 0}
    plain_valid = lc._valid_frames

    def counted_valid(*a, **kw):
        seen["valid"] += 1
        return plain_valid(*a, **kw)

    lc._valid_frames = counted_valid

    def closure_info(a, out):
        """Where the closure stopped: after its Sim3 (no Sim3, or the
        near-identity gate), at the frames' validity, or after the
        correction."""
        stop = ("correction" if len(lc.routes) > seen["routes"] else
                "valid" if seen["valid"] > seen.get("valid_then", 0) else "sim3")
        seen["routes"], seen["valid_then"] = len(lc.routes), seen["valid"]
        return {"stopped_at": stop}

    def reloc_info(a, out):
        n = sess.reloc_attempts - reloc_info.n
        reloc_info.n = sess.reloc_attempts
        return {"candidates": n}

    reloc_info.n = 0
    drifts = []
    plain_sim3 = lc.compute_sim3

    def compute_sim3(state, i, j, *a, **kw):
        """Each Sim3 found, with the near-identity gate's three drifts."""
        S, n = plain_sim3(state, i, j, *a, **kw)
        if S is not None:
            drifts.append({"i": i, "j": j, **gate_drifts(lc._sim3_host["xi"])})
        return S, n

    lc.compute_sim3 = compute_sim3
    reads.wrap(lc, "close", "closure", closure_info)
    reads.wrap(sess, "_try_relocalize", "relocalization", reloc_info)
    reads.wrap(sess, "_cull_dispatch", "cull_dispatch")
    reads.wrap(sess, "_cull_apply", "cull_apply")
    reads.wrap(sess, "_untracked", "untracked_frame",
               lambda a, out: {"bootstrap": out.frame > 0})
    launches.reset()
    try:
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(frames.shape[0]):
            sess.add_frame(frames[i], k, i / 30.0)
        sess.flush()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        reads.restore()
    counted = launches.read()
    steps = sess.step_launches
    calls = sess.program_calls
    poses, valid, _ = sess.trajectory()
    rv = valid[real]
    r = ate_mod.ate(poses[real][rv], poses_gt[rv])
    out = {
        "vocabulary": label, "route": "op by op" if eager else "programs",
        "frames": int(frames.shape[0]), "real_frames": len(real),
        "tracked_real": int(rv.sum()), "tracked_noise": int(valid.sum() - rv.sum()),
        "ate_m": r.rmse, "fps": frames.shape[0] / wall, "wall_s": wall, "closures": lc.closures,
        "corrected": lc.corrected, "skipped_identity": lc.skipped_identity,
        "reverted": lc.reverted, "culled_keyframes": sorted(sess._kf_culled),
        "keyframes": len(sess.keyframes), "keyframe_list": sess.keyframes,
        "reloc_attempts": sess.reloc_attempts, "reloc_successes": sess.reloc_successes,
        "k2_in_reloc": [c["launches"]["hamming_top2"] for c in calls if c["kind"] == "relocalize"],
        "k1_launches": counted["corner_maps"], "k2_launches": counted["hamming_top2"],
        "launches": counted,
        "step_min": {n: min((c[n] for c in steps), default=0) for n in launches.KERNELS},
        "gate_drifts": drifts, "timings_s": lc.timings, "routes": lc.routes,
        "host_reads": reads.events, "host_reads_by_kind": reads.by_kind(),
        "capture_syncs": reads.capture_syncs,
        "program_launches": [(c["kind"], c["launches"]) for c in calls],
        "programs": program_summary(sess),
        "tracked_flags": [bool(s.tracked) for s in sess.stats],
        "poses": poses, "valid": valid,
    }
    return out, sess


def gate_drifts(xi) -> dict:
    """The near-identity gate's drifts of a Sim3 log xi = (t, w, log s)
    (`slam/loop_closer.py`: the closure is skipped when all three lie below
    their thresholds, `LoopClosureConfig.id_rot_rad`, `id_trans`,
    `id_log_scale`)."""
    xi = np.asarray(xi, np.float64)
    return {"rot": float(np.linalg.norm(xi[3:6])), "trans": float(np.linalg.norm(xi[0:3])),
            "log_scale": abs(float(xi[6]))}


def _loop_checks(out, real) -> list:
    """The loop phase's limits on one run."""
    fails = []
    if not any(i - j >= 40 for i, j in out["closures"]):
        fails.append(f"no closure with i - j >= 40: {out['closures']}")
    if out["reloc_attempts"] < 1 or not any(n > 0 for n in out["k2_in_reloc"]):
        fails.append(f"no relocalization attempt that launched K2: {out['k2_in_reloc']}")
    if out["tracked_real"] < len(real) - 6:
        fails.append(f"tracked {out['tracked_real']} of {len(real)} real frames")
    if not out["ate_m"] <= LOOP_MAX_ATE_M:
        fails.append(f"ATE {out['ate_m']} m > {LOOP_MAX_ATE_M} m")
    if out["k1_launches"] < out["frames"]:
        fails.append(f"K1 launched {out['k1_launches']} times, < 1 per frame")
    return fails


def _program_checks(out) -> list:
    """Host reads a program-driven event and the kernels inside every Sim3,
    relocalization candidate and bootstrap replay."""
    fails = []
    for ev in out["host_reads"]:
        k, n = ev["kind"], ev["total"]
        if k == "closure" and n > CLOSURE_READS[ev["stopped_at"]]:
            fails.append(f"a closure stopped at {ev['stopped_at']} read the card {n} times")
        if k == "relocalization" and n > 1 + ev["candidates"]:
            fails.append(f"a relocalization attempt of {ev['candidates']} candidates read {n} times")
        if k in ("cull_dispatch", "cull_apply") and n > (0 if k == "cull_dispatch" else CULL_READS):
            fails.append(f"{k} read the card {n} times")
        if k == "untracked_frame" and n > (BOOTSTRAP_READS if ev["bootstrap"] else 0):
            fails.append(f"an untracked frame (bootstrap {ev['bootstrap']}) read the card {n} times")
    need = {"sim3": ("hamming_top2", "svd3"), "relocalize": ("hamming_top2", "small_eigh"),
            "bootstrap": ("small_eigh", "svd3")}
    for kind, c in out["program_launches"]:
        if kind in need and any(c[n] < 1 for n in need[kind]):
            fails.append(f"a {kind} replay launched {c}, not {need[kind]}")
    for kind in need:
        if not any(k == kind for k, _ in out["program_launches"]):
            fails.append(f"no {kind} program ran")
    return fails


LOOP_FIXTURE = ROOT / "tests" / "fixtures" / "reference_loop_course.npz"
LOOP_FLAG_FRAC = 0.05  # tracked flags of the real frames may differ on at most this share
LOOP_PAIR_FRAMES = 3  # a closure's partner on the other side: within this on both i and j
LOOP_GATE_EDGE = 0.25  # a corrected/skipped flip is allowed only this close to the gate


def gate_ratio(d: dict, gate) -> float:
    """The near-identity gate's deciding ratio: the largest drift over its
    threshold. Below 1 the closure is skipped, above it corrected; a
    decision can flip with rounding only where this is near 1."""
    return max(d["rot"] / gate[0], d["trans"] / gate[1], d["log_scale"] / gate[2])


def against_reference(out, real) -> tuple[dict, list]:
    """The loop course's run held to the JAX reference's run of it
    (`LOOP_FIXTURE`): (report, failures). Tracked flags of the real frames
    may differ on at most LOOP_FLAG_FRAC of them; every closure on either
    side needs a partner on the other within LOOP_PAIR_FRAMES on both i
    and j; a partnered closure's corrected/skipped decision may differ only
    where the reference's deciding drift lies within LOOP_GATE_EDGE of its
    threshold (|ratio - 1| <= LOOP_GATE_EDGE)."""
    with np.load(LOOP_FIXTURE) as f:
        fx = {n: f[n] for n in f.files}
    gate = fx["gate"]
    flags = np.asarray(out["tracked_flags"])[real]
    n_diff = int((flags != fx["tracked_real"]).sum())

    def drift_of(drifts, i, j):
        return next((d for d in drifts if (d["i"], d["j"]) == (i, j)), None)

    ref_drifts = [{"i": int(i), "j": int(j), **gate_drifts(x)}
                  for (i, j), x in zip(fx["sim3_pairs"], fx["sim3_xi"])]
    ref_closures = [tuple(int(v) for v in c) for c in fx["closures"]]
    ref_corrected = {tuple(int(v) for v in c) for c in fx["corrected"]}
    card_closures = [tuple(c) for c in out["closures"]]
    card_corrected = {tuple(c) for c in out["corrected"]}

    def partner(c, others):
        return next((o for o in others if abs(o[0] - c[0]) <= LOOP_PAIR_FRAMES
                     and abs(o[1] - c[1]) <= LOOP_PAIR_FRAMES), None)

    rows, fails = [], []
    for c in ref_closures:
        p = partner(c, card_closures)
        rd, cd = drift_of(ref_drifts, *c), drift_of(out["gate_drifts"], *p) if p else None
        row = {"reference": list(c), "card": list(p) if p else None,
               "reference_decision": "corrected" if c in ref_corrected else "skipped",
               "card_decision": None if p is None else
               ("corrected" if p in card_corrected else "skipped"),
               "reference_drifts": rd, "card_drifts": cd,
               "reference_gate_ratio": gate_ratio(rd, gate) if rd else None,
               "card_gate_ratio": gate_ratio(cd, gate) if cd else None}
        rows.append(row)
        if p is None:
            fails.append(f"the reference's closure {c} has no partner on the card")
        elif row["card_decision"] != row["reference_decision"] and not (
                rd is not None and abs(row["reference_gate_ratio"] - 1) <= LOOP_GATE_EDGE):
            fails.append(f"closure {c}: the card {row['card_decision']}, the reference "
                         f"{row['reference_decision']} at gate ratio {row['reference_gate_ratio']}")
    for c in card_closures:
        if partner(c, ref_closures) is None:
            fails.append(f"the card's closure {c} has no partner in the reference's run")
            rows.append({"reference": None, "card": list(c), "card_decision":
                         "corrected" if c in card_corrected else "skipped",
                         "card_drifts": drift_of(out["gate_drifts"], *c)})
    if n_diff > LOOP_FLAG_FRAC * len(real):
        fails.append(f"tracked flags of {n_diff} of {len(real)} real frames differ")
    report = {
        "tracked_real": [int(flags.sum()), int(fx["tracked_real"].sum())],
        "tracked_flags_differ": n_diff, "closures": rows,
        "reverted": [out["reverted"], fx["reverted"].tolist()],
        "reloc_attempts": [out["reloc_attempts"], int(fx["reloc_attempts"])],
        "reloc_successes": [out["reloc_successes"], int(fx["reloc_successes"])],
        "keyframes": [len(out["keyframe_list"]), len(fx["keyframes"])],
        "gate": gate.tolist(),
    }
    return report, fails


AB_FIELDS = ("closures", "corrected", "skipped_identity", "reverted", "reloc_attempts",
             "reloc_successes", "culled_keyframes", "keyframes", "keyframe_list", "tracked_flags")


def phase_loop(dev="cuda") -> dict:
    """The loop course through the programs and op by op (the A/B): equal
    outcomes, poses within TRAJ_TOL_M, both runs within the phase's limits;
    the programs' host reads and kernel launches checked; capture seconds,
    ms a call, the graph pool's bytes and the stage split of both routes
    reported."""
    from monocular_slam_tpu_torch.ops import features
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.utils import prng

    t0 = time.perf_counter()
    frames, real, poses_gt, k = _loop_frames(torch.device(dev))
    log(f"[loop] rendered {LOOP_FRAMES} frames + {BLACKOUT} noise frames in "
        f"{time.perf_counter() - t0:.2f} s")
    voc = vocabulary.load_default(dev)
    out, sess = run_loop(frames, real, poses_gt, k, voc, "bundled")
    if not any(i - j >= 40 for i, j in out["closures"]):
        # the reference's e2e test trains on the course itself (k=8, L=4)
        descs = []
        for i in real[::2]:
            f = features.extract(frames[i], n_features=1000)
            descs.append(f.desc_pm1[f.valid].cpu().numpy())
        voc = vocabulary.train(np.concatenate(descs), k=8, L=4, seed=0, device=dev)
        out, sess = run_loop(frames, real, poses_gt, k, voc, "trained k=8 L=4 on the course")
        log("[loop] no closure with the bundled vocabulary; retrained")
    eager, _ = run_loop(frames, real, poses_gt, k, voc, out["vocabulary"], eager=True)
    v = out["valid"] & eager["valid"]
    diff = float(np.abs(out["poses"][v] - eager["poses"][v]).max())
    unequal = [f for f in AB_FIELDS if out[f] != eager[f]]
    hidden = ("poses", "valid", "tracked_flags", "keyframe_list", "host_reads", "program_launches",
              "against_reference")
    for o in (out, eager):
        log("[loop] " + json.dumps({n: v for n, v in o.items() if n not in hidden}))
    log("[loop] host reads by event, programs: " + json.dumps(out["host_reads_by_kind"])
        + "; op by op: " + json.dumps(eager["host_reads_by_kind"]))
    log("[loop] programs: " + json.dumps(out["programs"]))
    log("[loop] stage split (device ms by program kind; wall s): programs "
        + json.dumps({kd: round(d["device_ms"], 3) for kd, d in out["programs"]["by_kind"].items()})
        + f" of {out['wall_s']:.3f} s; op by op "
        + json.dumps({kd: round(d["device_ms"], 3) for kd, d in eager["programs"]["by_kind"].items()})
        + f" of {eager['wall_s']:.3f} s")
    fails = [f"programs: {m}" for m in _loop_checks(out, real) + _program_checks(out)]
    fails += [f"op by op: {m}" for m in _loop_checks(eager, real)]
    ref, ref_fails = against_reference(out, real)
    out["against_reference"] = ref
    log("[loop] against the reference's run (card, reference): " + json.dumps(ref))
    fails += [f"against the reference: {m}" for m in ref_fails]
    if unequal or not diff <= TRAJ_TOL_M:
        fails.append(f"programs vs op by op: unequal {unequal}, max pose difference {diff} m")
    last = frames.shape[0] - 1
    with torch.inference_mode():
        res = tracker.relocalize(sess.state, last, last - 1, prng.PRNGKey(11), sess.cfg)
    ok, n = bool(res.ok), int(res.n_inliers)
    log(f"[loop] closures {out['closures']}, corrected {out['corrected']}, skipped-identity "
        f"{out['skipped_identity']}, reverted {out['reverted']}, culled keyframes "
        f"{len(out['culled_keyframes'])}, relocalization {out['reloc_successes']}/"
        f"{out['reloc_attempts']} attempts succeeded, K2 launches {out['k2_launches']}, tracked "
        f"{out['tracked_real']}/{len(real)} real frames, ATE {out['ate_m'] * 100:.3f} cm, "
        f"{out['fps']:.2f} fps (op by op {eager['fps']:.2f}); programs = op by op in every "
        f"outcome: {not unequal}, max pose difference {diff:.3g} m; direct relocalize of frame "
        f"{last} against {last - 1}: ok {ok}, {n} inliers")
    if not ok or n < sess.cfg.track.reloc_min_inliers:
        fails.append(f"direct relocalize failed ({ok}, {n} inliers)")
    if fails:
        raise AssertionError("loop: " + "; ".join(fails))
    out["max_pose_diff_vs_op_by_op_m"] = diff
    out["op_by_op"] = {n: eager[n] for n in ("fps", "wall_s", "host_reads_by_kind", "programs")}
    log("[loop] graph nodes a program (device operations of one replay, after the run): "
        + json.dumps(program_nodes(sess)))
    return out, sess


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
            dense, t_d, _ = timed_solve(lambda: lc._gba_impl(
                st, pad, len(kfs), keep("ba_dense", lc.global_ba_solver(cg=False))))
            cg, t_c, _ = timed_solve(lambda: lc._gba_impl(
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
                res[bucket] = timed_solve(lambda c=c: c.correct(state, i, j, S,
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
                st, pad, len(kfs), lc.global_ba_solver(cg=False)), dev),
            "global_ba_cg_raw_and_summarized": device_ops(lambda: lc._gba_impl(
                st, pad, len(kfs), lc.global_ba_solver(cg=True)), dev, summarized=True),
            **{f"correct_{name}": device_ops(lambda c=c: c.correct(state, i, j, S,
                                                                  keyframes=list(sess._keyframes)),
                                             dev)
               for name, c in closers.items()},
        }
    return out


def phase_scale(loop_sess, loop_out, dev="cuda") -> dict:
    """The matrix-free solvers at benchmarks/kitti_scale.py's scale through
    the port's `benchmarks.kitti_scale`, the map-scale matching of
    `benchmarks.loop_match_scale` (K2 launches counted), then CG against
    dense on the loop phase's final state."""
    from monocular_slam_tpu_torch.benchmarks import kitti_scale, loop_match_scale
    from monocular_slam_tpu_torch.ops import launches

    dev = torch.device(dev)
    out = {}
    out["pose_graph"], res = kitti_scale.bench_pose_graph(SCALE_KF, SCALE_LOOPS, SCALE_ITERS, dev)
    log("[scale] pose graph " + json.dumps(out["pose_graph"]))
    c0, c1 = out["pose_graph"]["chi2_initial"], out["pose_graph"]["chi2_final"]
    if not (torch.isfinite(res.vertices).all() and c1 * 10 <= c0):
        raise AssertionError(f"scale: CG pose graph chi2 {c0} -> {c1}")

    out["global_ba"], res = kitti_scale.bench_cg_ba(*SCALE_BA, SCALE_ITERS, dev)
    log("[scale] global BA " + json.dumps(out["global_ba"]))
    hist, c0 = out["global_ba"]["chi2_history"], out["global_ba"]["chi2_initial"]
    floor = out["global_ba"]["chi2_statistical_floor"]
    finite = bool(torch.isfinite(res.poses).all() and torch.isfinite(res.points).all())
    if not (finite and hist[-1] * 10 <= c0 and hist[-1] <= 2.0 * floor):
        raise AssertionError(f"scale: CG BA finite {finite}, chi2 {c0} -> {hist[-1]} "
                             f"(floor {floor})")

    launches.reset()
    # sections 1-3; the direct-index section runs in the drivers phase
    out["loop_match_scale"] = loop_match_scale.run(device=dev, maps=())
    k2 = launches.read()["hamming_top2"]
    out["loop_match_scale"]["k2_launches"] = k2
    log("[scale] loop_match_scale " + json.dumps(out["loop_match_scale"]))
    if k2 < 1:
        raise AssertionError("scale: the map-scale match launched no K2")

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
        res, t, _ = timed_solve(lambda: sharded_ba.distributed_bundle_adjust(
            prob, mesh, n_iters=SCALE_ITERS, solver=solver, max_cg_iters=100))
        row = {"s": t, "chi2_initial": float(res.chi2_initial),
               "chi2_final": float(res.chi2_history[-1]),
               "finite": bool(torch.isfinite(res.poses).all() and torch.isfinite(res.points).all())}
        if rank == 0:
            ref, t_ref, _ = timed_solve(single_fn)
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
    port = free_port()
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

    from monocular_slam_tpu_torch.benchmarks import kitti_scale
    from monocular_slam_tpu_torch.optim import ba, cg_ba, pose_graph
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba, sharded_pose_graph
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        out["backend"] = dist.get_backend(mesh.get_group("model"))
        prob, _ = kitti_scale.ba_problem(*SCALE_BA, "cuda")
        F = prob.poses.shape[0]
        kw = dict(n_iters=SCALE_ITERS, max_cg_iters=50)
        # two calls of each route; the second is timed (the first of the
        # sharded route also sets up NCCL's communicator)
        single = [timed_solve(lambda: cg_ba.bundle_adjust_cg(prob, **kw)) for _ in range(2)]
        with distributed.record_collectives() as rec:
            shard = [timed_solve(lambda: sharded_ba.distributed_bundle_adjust(
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

        g = kitti_scale.pose_graph_problem(SCALE_KF, SCALE_LOOPS, "cuda")
        pg_single = [timed_solve(lambda: pose_graph.optimize_cg(g, n_iters=SCALE_ITERS))
                     for _ in range(2)]
        with distributed.record_collectives() as rec:
            pg_shard = [timed_solve(lambda: sharded_pose_graph.distributed_optimize(
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
            ref, t_ref, _ = timed_solve(lambda: ba.bundle_adjust(pr, n_iters=n))
            dd, t_dd, _ = timed_solve(lambda: sharded_ba.distributed_bundle_adjust(
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
    """`benchmarks/long_run.py`'s configuration through the port's
    `benchmarks.long_run.run_long`, cut to LONG_FRAMES frames rendered on
    the card, at the reference's dense/CG switch."""
    from monocular_slam_tpu_torch.benchmarks import long_run

    with reference_pose_graph_switch():
        out, sess = long_run.run_long(LONG_FRAMES)
    for name in ("poses", "valid", "poses_gt"):
        del out[name]
    out["programs"] = program_summary(sess)
    log("[long] " + json.dumps(out))
    log("[long] graph nodes a program (device operations of one replay, after the run): "
        + json.dumps(program_nodes(sess)))
    n = out["frames"]
    log(f"[long] {n} frames: tracked {out['tracked']}, ATE {out['ate_m'] * 100:.2f} cm "
        f"(max |det R - 1| {out['max_rotation_det_dev']:.2g}), "
        f"{out['fps']:.2f} fps ({out['fps_50_on']:.2f} from frame 50), prewarm "
        f"{out['prewarm_s']:.2f} s, closures {out['closures']}, first Sim3 "
        f"{out['sim3_s'][0] if out['sim3_s'] else float('nan'):.3f} s, routes "
        f"{[(r['K_pad'], r['pose_graph'], r.get('global_ba')) for r in out['routes']]}, "
        f"correction programs held for K_pad {out['correction_buckets_held']}, "
        f"evicted {out['frames_evicted']}, "
        f"K1 {out['k1_launches']}, K2 {out['k2_launches']} in {out['track_calls']} track calls")
    if out["nonfinite_poses"]:
        raise AssertionError(f"long: {out['nonfinite_poses']} non-finite poses")
    if out["tracked"] < 0.95 * n:
        raise AssertionError(f"long: tracked {out['tracked']} < 95% of {n}")
    if len(out["closures"]) < 2:
        raise AssertionError(f"long: {len(out['closures'])} closures < 2")
    if not (any(r["pose_graph"] == "cg" for r in out["routes"])
            and any(r.get("global_ba") == "cg" for r in out["routes"])):
        raise AssertionError(f"long: a CG route was never taken: {out['routes']}")
    if out["frames_evicted"] < 1:
        raise AssertionError("long: no feature slot was evicted")
    if out["k1_launches"] != n:
        raise AssertionError(f"long: K1 launched {out['k1_launches']} times for {n} frames")
    if any(out["step_min"][n] < STEP_MIN_LAUNCHES[n] for n in STEP_MIN_LAUNCHES):
        raise AssertionError(f"long: fewest launches in a tracked step {out['step_min']}")
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


def cli_in_process(root: str, out_dir: str, sub_dir: str, sub: dict) -> dict:
    """The cli course again through `run.main` in this process, after every
    other phase: its trajectory file must equal the subprocess's byte for
    byte, its tracked count and closures the subprocess's, and it must meet
    the phase's limits on its own."""
    t0 = time.perf_counter()
    summary, _ = _run_main_inprocess(cli_args(root, out_dir) + ["--verbose"])
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "trajectory.txt"), "rb") as a, \
            open(os.path.join(sub_dir, "trajectory.txt"), "rb") as b:
        same = a.read() == b.read()
    closures = summary.get("loop_closures", [])
    log(f"[cli] in process: tracked {summary['tracked']}, ATE {summary['ate_rmse'] * 100:.3f} cm, "
        f"closures {closures}, {wall:.1f} s; trajectory file equal to the subprocess's: {same}")
    if not same:
        raise AssertionError("cli: the in-process run's trajectory file differs from the "
                             "subprocess's")
    if summary["tracked"] != sub["tracked"] or closures != sub.get("loop_closures", []):
        raise AssertionError(f"cli: in process {summary}, subprocess {sub}")
    if summary["tracked"] < CLI_MIN_TRACKED or not summary["ate_rmse"] <= CLI_MAX_ATE_M or not any(
            i - j >= 40 for i, j in closures):
        raise AssertionError(f"cli: the in-process run is out of the limits: {summary}")
    return {"summary": summary, "trajectory_equal": same, "s": wall}


def phase_cli() -> dict:
    """The CLI course as a subprocess, then KITTI layout and the synthetic
    route in process. On success the course's directory stays for
    `cli_in_process` under `work` (the caller removes it)."""
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
        out["course"] = {"work": work, "root": root, "out_dir": out_dir}
        return out
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


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
    timed("draws", phase_draws)
    res = timed("session", phase_session)
    k3 = timed("k3", phase_k3)
    pg = timed("pose_gn", phase_pose_gn)
    prog = timed("program", phase_program, res)
    k2 = timed("k2", phase_k2, res["imgs"])
    timed("lc60", phase_lc60, res)
    bench_out = timed("bench", phase_bench)
    loop, loop_sess = timed("loop", phase_loop)
    timed("scale", phase_scale, loop_sess, loop)
    timed("dist", phase_dist, res, loop_sess)
    timed("long", phase_long)
    cli = timed("cli", phase_cli)
    course = cli["course"]
    try:
        timed("mesh", phase_mesh, cli)
        drivers = timed("drivers", phase_drivers)
        timed("cli_in_process", cli_in_process, course["root"],
              os.path.join(course["work"], "out_in_process"), course["out_dir"], cli["summary"])
    finally:
        shutil.rmtree(course["work"], ignore_errors=True)
    log("[done] seconds by phase " + json.dumps(seconds))
    k1 = res["k1"]
    win = k2[WINDOW]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; loop K1 launches "
        f"{loop['k1_launches']}, K2 launches {loop['k2_launches']}")

    def on_bench(kernel):
        """A kernel's launches in the bench phase: its four image passes
        (each counted from 0 after its prewarm) and the fused step's replays."""
        return {"launches_bench_passes": sum(p["launches"][kernel]
                                             for p in bench_out["passes"].values()),
                "launches_bench_fused_step": bench_out["fused_launches"][kernel]}

    def on_loop(kernel):
        """A kernel's launches in the loop phase's run through the programs:
        all of them, and those inside each kind of program outside the
        tracked step (Sim3, relocalization, bootstrap, ...)."""
        return {"launches_loop": loop["launches"][kernel],
                "launches_loop_programs": {kd: d["launches"][kernel] for kd, d in
                                           loop["programs"]["by_kind"].items()
                                           if d["launches"][kernel]}}

    log(json.dumps({"kernels": [
        {"name": "fast_corner_maps_levels", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": res["k1_launches"],
         "launches_cli": cli["kernel_launches"]["fast_corner_maps_levels"],
         **on_loop("corner_maps"), **on_bench("corner_maps"),
         "launches_drivers": drivers["launches"]["corner_maps"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "hamming_top2", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": res["k2_launches"],
         "launches_cli": cli["kernel_launches"]["hamming_top2"], **on_loop("hamming_top2"),
         **on_bench("hamming_top2"), "launches_drivers": drivers["launches"]["hamming_top2"],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()), "ms": win["ms"],
         "plain_ms": win["plain_ms"], "bound_ms": win["bound_ms"], "bound_by": win["bound_by"],
         "library_ms": None},
        {"name": "small_eigh", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": res["k3_launches"], **on_loop("small_eigh"),
         **on_bench("small_eigh"), "launches_drivers": drivers["launches"]["small_eigh"],
         "max_abs_err": max(k3[n]["max_abs_err"] for n in k3 if n.startswith("eigh")),
         **{f: k3["eigh (1000, 4, 4)"][f] for f in K3_FIELDS},
         "shapes": {n: {f: k3[n][f] for f in K3_FIELDS + ("device_ms",)}
                    for n in k3 if n.startswith("eigh")}},
        {"name": "svd3", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_SVD_REPLACES, "launches": res["k3_svd_launches"], **on_loop("svd3"),
         **on_bench("svd3"), "launches_drivers": drivers["launches"]["svd3"],
         "max_abs_err": max(k3[n]["max_abs_err"] for n in k3 if n.startswith("svd3")),
         **{f: k3["svd3 (1, 3, 3)"][f] for f in K3_FIELDS},
         "shapes": {n: {f: k3[n][f] for f in K3_FIELDS + ("device_ms",)}
                    for n in k3 if n.startswith("svd3")}},
        {"name": "pose_gn", "route": "cuda", "source": POSE_GN_SOURCE,
         "replaces": POSE_GN_REPLACES, "launches": res["pose_gn_launches"],
         **on_loop("pose_gn"), **on_bench("pose_gn"),
         "launches_drivers": drivers["launches"]["pose_gn"],
         "max_abs_err": max(r["rot_rad"] for r in pg.values()),
         **{f: pg["(1, 1000)"][f] for f in POSE_GN_FIELDS},
         "shapes": {n: {f: r[f] for f in POSE_GN_FIELDS} for n, r in pg.items()}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main_program() -> int:
    """`python3 chip_smoke.py program`: the build, K3, pose_gn and the step
    program phases alone, on the session phase's course."""
    from monocular_slam_tpu_torch.datasets import render

    phase_device()
    phase_build()
    phase_k3()
    phase_pose_gn()
    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=N_FRAMES, wh=WH, device="cuda")
    phase_program({"imgs": imgs, "poses_gt": poses_gt, "k": k})
    log("[done] program phases passed")
    return 0


def main_phase(name: str) -> int:
    """`python3 chip_smoke.py loop`, `long`, `bench` or `drivers`: the build
    and that phase alone."""
    phase_device()
    phase_build()
    {"loop": phase_loop, "long": phase_long, "bench": phase_bench,
     "drivers": phase_drivers}[name]()
    log(f"[done] {name} phase passed")
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
    if sys.argv[1:] in (["loop"], ["long"], ["bench"], ["drivers"]):
        sys.exit(main_phase(sys.argv[1]))
    sys.exit(main_program() if sys.argv[1:] == ["program"] else main())
