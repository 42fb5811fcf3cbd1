"""The flagship benchmark on the card (the counterpart of `bench.py`).

    python -m monocular_slam_tpu_torch.bench          # on the card
    python -m monocular_slam_tpu_torch.bench --device cpu

Prints ONE JSON line with `bench.py`'s keys:

  1. the image pipeline: the rendered TUM-format course (`render.export_tum`
     seed 11, 60 frames at 640x480, cached under $MSLAM_BENCH_TUM), read
     through `tum.load` and the native batch decode into one buffer on the
     card (`ingest_ms_per_frame`), then `add_frame_from_buffer` frame by
     frame: fps over frames 10-59 (`value`), ATE and frames tracked; the
     same with the bundled vocabulary's `LoopCloser` attached (`lc_fps`,
     `lc_ate_cm`); and frames decoded by 2 threads 6 ahead of the card and
     uploaded one by one (`ingest_overlapped_fps`). Each pass is a fresh
     session: the reference's passes share its compiled programs, so each
     session here captures its programs (`prewarm`) before its first frame.
  2. the feature path (`synthetic.feature_sequence(PRNGKey(0))`, 40 frames
     of 1000 features) and, from its final state, the fused step
     `tracker.track` + `local_ba.local_bundle_adjust` at frame 39 as one
     captured program chained 30 times (`kernel_fps`; the replay's last
     operations copy its output state into its inputs, as in every
     chained replay of the drivers: `benchmarks.Replayed`), and
     `cfg.ba.local_iters` LM iterations over one replayed local BA
     (`ba_iters_per_sec`).
  3. `rooflines`: K1 at 640x480 and the matcher at 1000x1000 against their
     operation and byte counts (the kernels' formulas); the session step,
     the local BA and the extraction with their wall time and device
     operations only (PyTorch has no compiled-program cost model), so `mfu`
     is null.

`vs_baseline` divides by the reference's own estimate of 10 fps for its
C++ ancestor (`bench.py`'s REFERENCE_FPS_ESTIMATE), kept as it stands.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from monocular_slam_tpu_torch.benchmarks import Replayed, device_label, device_ops, mean_seconds, sync

REFERENCE_FPS_ESTIMATE = 10.0  # the reference's estimate (bench.py), not a measurement
COURSE_SEED = 11
FEATURE_SEED = 0
FUSED_KEY = 7
SKIP = 10  # frames before the timed window
N_REP = 30
K1_OPS_PER_PX = 160  # 16 ring differences, the two circular min-9 passes, NMS
K1_BYTES_PER_PX = 12
NO_COST_MODEL = ("PyTorch has no compiled-program cost model like XLA's cost_analysis: wall "
                 "time and device operations only, no operation count is invented")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# --- the course on disk ------------------------------------------------------------

def bench_course(root: str, n_frames: int, wh, device):
    """`tum.load` of the course under `root`, exported first (rendered on
    `device`) unless the directory holds this render version's course of
    n_frames frames at `wh` (`bench.py`'s VERSION check)."""
    from monocular_slam_tpu_torch.datasets import render, tum

    vfile = os.path.join(root, "VERSION")
    cached = open(vfile).read().strip() if os.path.exists(vfile) else None
    seq = None
    if os.path.exists(os.path.join(root, "rgb.txt")) and cached == str(render.RENDER_VERSION):
        seq = tum.load(root)
        if len(seq.frames) != n_frames or tuple(seq.wh) != tuple(wh):
            seq = None
    if seq is None:
        log("rendering TUM-format benchmark dataset ...")
        render.export_tum(root, seed=COURSE_SEED, n_frames=n_frames, wh=tuple(wh), device=device)
        seq = tum.load(root)
    return seq


# --- chained captured programs --------------------------------------------------------

def fused_step(cfg, i: int):
    """`bench.py`'s `frame_step`: `tracker.track` then
    `local_ba.local_bundle_adjust` at frame i; the key is a host key on the
    CPU, the words of its PnP half on a card. Extra outputs: tracked, PnP
    inliers, new points."""
    from monocular_slam_tpu_torch.slam import local_ba, tracker

    def fn(state, key):
        dev = state.poses.device
        it = torch.full((), i, dtype=torch.int64, device=dev)
        if torch.is_tensor(key):
            t = tracker.track(state, it, None, cfg, pnp_key=key)
        else:
            t = tracker.track(state, it, key, cfg)
        b = local_ba.local_bundle_adjust(t.state, it, cfg)
        return b.state, torch.stack([t.ok.to(torch.int32), t.n_pnp_inliers.to(torch.int32),
                                     t.n_new_points.to(torch.int32)])

    return fn


def local_ba_step(cfg, i: int):
    """`bench.py`'s `ba_only`: one `local_bundle_adjust` at frame i."""
    from monocular_slam_tpu_torch.slam import local_ba

    def fn(state):
        it = torch.full((), i, dtype=torch.int64, device=state.poses.device)
        b = local_ba.local_bundle_adjust(state, it, cfg)
        return b.state, b.chi2_final

    return fn


def bench_fused_step(cfg, warm_state, device, i: int, n_rep: int = N_REP):
    """Steady-state fused step chained n_rep times from the warm state, the
    link r keyed `fold_in(PRNGKey(7), r)`. Returns (seconds a step, the
    chain, each link's (tracked, inliers, new points), the kernels'
    launches over the n_rep replays)."""
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.utils import graph, prng

    dev = torch.device(device)
    key = prng.PRNGKey(FUSED_KEY)
    chain = Replayed(fused_step(cfg, i), warm_state, dev, key, extra=True)
    chain.step(key)  # the reference's first (compiling) call
    chain.reset(warm_state)
    if dev.type == "cuda":
        launches.reset()
    links = []
    sync(dev)
    t0 = time.perf_counter()
    for r in range(n_rep):
        links.append(graph.cloned(chain.step(prng.fold_in(key, r))))
    sync(dev)
    dt = (time.perf_counter() - t0) / n_rep
    counted = launches.read() if dev.type == "cuda" else None
    return dt, chain, [x.tolist() for x in links], counted


def bench_ba_iters(cfg, warm_state, device, i: int, n_rep: int = N_REP):
    """LM iterations a second of the windowed local BA: `cfg.ba.local_iters`
    over the seconds of one replay, chained n_rep times. Returns
    (iterations a second, seconds a call, the chain)."""
    dev = torch.device(device)
    chain = Replayed(local_ba_step(cfg, i), warm_state, dev, extra=True)
    chain.step()
    chain.reset(warm_state)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        chain.step()
    sync(dev)
    dt = (time.perf_counter() - t0) / n_rep
    return cfg.ba.local_iters / dt, dt, chain


def roofline_names(wh, n_feat: int) -> dict:
    """The rows' names: `bench.py`'s at its sizes (matcher_1kx1k,
    fast_640x480, extract_640x480), the sizes measured otherwise."""
    W, H = wh
    m = "1kx1k" if n_feat == 1000 else f"{n_feat}x{n_feat}"
    return {"matcher": f"matcher_{m}", "fast": f"fast_{W}x{H}", "extract": f"extract_{W}x{H}"}


def _no_cost_row(wall_s: float, n_ops) -> dict:
    return {"flops": None, "bytes": None, "wall_ms": wall_s * 1e3, "intensity_flop_per_byte": None,
            "mfu": None, "hbm_frac": None, "bound": None, "sol_frac": None, "device_ops": n_ops,
            "note": NO_COST_MODEL}


def bench_rooflines(cfg, warm_state, device, fused_chain, ba_chain, step_dt, ba_dt, n_feat,
                    wh=(640, 480)) -> dict:
    """`bench.py`'s five rows: K1 at `wh` (12 B and 160 f32 operations a
    pixel) and the kernel matcher on frames 10 and 11 (two K2 launches,
    forward and cross-check: 2 N M 256 int8 operations and N 256 + M 257 +
    12 N bytes each) through `roofline.analyze`; the session step (the
    fused chain's step), the local BA and the extraction with wall time and
    device operations only."""
    from monocular_slam_tpu_torch.ops import fast_score, features, matching
    from monocular_slam_tpu_torch.slam import state as state_mod
    from monocular_slam_tpu_torch.utils import prng, roofline

    dev = torch.device(device)
    peaks = roofline.device_peaks(dev)
    out = {}

    def replay_ops(chain):
        if chain.program is None:
            return None
        saved = chain.current()
        n = device_ops(chain.step, dev)
        chain.reset(saved)
        return n

    W, H = wh
    names = roofline_names(wh, n_feat)
    out["session_step"] = _no_cost_row(step_dt, replay_ops(fused_chain))
    out["session_step"]["note"] += "; the fused track + local BA step's wall time a link"
    out["local_ba"] = _no_cost_row(ba_dt, replay_ops(ba_chain))

    st = warm_state
    a_s, b_s = (int(state_mod.slot_index(st, f)) for f in (10, 11))
    a, b = st.desc_pm1[a_s].contiguous(), st.desc_pm1[b_s].contiguous()
    va, vb = st.kp_valid[a_s].contiguous(), st.kp_valid[b_s].contiguous()
    kern = dev.type == "cuda"

    def match():
        return matching.match(a, b, va, vb, ratio=0.8, max_dist=80, use_kernel=kern)

    with torch.inference_mode():
        m_dt = mean_seconds(match, dev, N_REP)
    N, M = a.shape[0], b.shape[0]
    ops = 2 * (2.0 * N * M * 256)
    nbytes = (N * 256 + M * 257 + 12 * N) + (M * 256 + N * 257 + 12 * M)
    out[names["matcher"]] = roofline.analyze(ops, nbytes, m_dt, peaks, "int8").as_dict() | {
        "device_ops": device_ops(match, dev),
        "note": "kernel route: forward and cross-check K2 launches, 2 N M 256 int8 operations "
                "and N 256 + M 257 + 12 N bytes each" if kern else "dense route (the CPU)"}

    img = 255.0 * prng.uniform_on(prng.PRNGKey(3), (H, W), dev)
    with torch.inference_mode():
        f_dt = mean_seconds(lambda: fast_score.corner_maps(img, 20.0), dev, N_REP)
        e_dt = mean_seconds(lambda: features.extract(img, n_features=n_feat), dev, N_REP)
    px = H * W
    out[names["fast"]] = roofline.analyze(K1_OPS_PER_PX * px, K1_BYTES_PER_PX * px, f_dt,
                                            peaks).as_dict() | {
        "device_ops": device_ops(lambda: fast_score.corner_maps(img, 20.0), dev),
        "note": f"K1, one level: {K1_BYTES_PER_PX} B and {K1_OPS_PER_PX} f32 operations a pixel"}
    with torch.inference_mode():
        out[names["extract"]] = _no_cost_row(e_dt, device_ops(
            lambda: features.extract(img, n_features=n_feat), dev))
    log(f"-- roofline ({peaks.name}: {peaks.peak_flops('int8') / 1e12:.0f} TOP/s int8, "
        f"{peaks.peak_flops() / 1e12:.0f} TF/s f32, {peaks.peak_bw / 1e9:.0f} GB/s) --")
    for name, r in out.items():
        log(f"  {name:16s} {r['wall_ms']:8.3f} ms  device ops {r['device_ops']}  "
            + (f"mfu {r['mfu'] * 100:.3f}%  hbm {r['hbm_frac'] * 100:.3f}% {r['bound']}-bound"
               if r["mfu"] is not None else "no cost model"))
    return out


# --- the image pipeline ---------------------------------------------------------------

def bench_image_pipeline(n_feat: int, device, n_frames: int = 60, wh=(640, 480), root=None):
    """The image pipeline on the rendered TUM course (see the module
    docstring). Returns (fps, ate_m, tracked, n_frames, warmup_s,
    ingest_ms_per_frame, lc_fps, overlapped fps, lc ate_m, details):
    `details` holds the decoded frames, each pass's K1 launches, tracked
    steps and fewest launches of each kernel in a tracked step, and the
    loop-closing pass's closures and relocalization attempts."""
    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    root = root or os.environ.get("MSLAM_BENCH_TUM",
                                  os.path.join(tempfile.gettempdir(), "mslam_bench_tum_torch"))
    seq = bench_course(root, n_frames, wh, dev)
    n = len(seq.frames)
    cfg = SlamConfig(max_frames=64 if n <= 64 else n, max_points=20000, image_wh=tuple(wh),
                     frontend=FrontendConfig(n_features=n_feat))
    gt = np.stack([f.pose_gt for f in seq.frames])
    passes = {}

    # ingest: threaded native PNG decode + ONE upload (the reference's FrameLoader preload)
    t0 = time.perf_counter()
    imgs = np.stack(seq.load_images_batch(range(n)))
    buf = torch.as_tensor(imgs).to(dev)
    sync(dev)
    ingest_ms = (time.perf_counter() - t0) / n * 1e3

    def counted(name, sess):
        """The pass's launches since the reset after its prewarm."""
        steps = sess.step_launches
        counts = launches.read() if cuda else None
        passes[name] = {"frames": n, "k1": counts["corner_maps"] if cuda else None,
                        "launches": counts, "track_calls": len(steps),
                        "step_min": {m: min((c[m] for c in steps), default=0)
                                     for m in launches.KERNELS}}

    # pass 1: warm-up (captures, then one whole pass)
    t0 = time.perf_counter()
    sess = SlamSession(cfg, seed=1, run_ba=True, device=dev)
    sess.prewarm(image=True, buffer=buf)
    if cuda:
        launches.reset()
    for i in range(n):
        sess.add_frame_from_buffer(buf, i, seq.k, seq.frames[i].timestamp)
    sess.flush()
    sync(dev)
    warmup_s = time.perf_counter() - t0
    counted("warmup", sess)

    def timed_pass(name, loop_closer=None):
        sess = SlamSession(cfg, seed=1, run_ba=True, loop_closer=loop_closer, device=dev)
        sess.prewarm(buffer=buf)
        if cuda:
            launches.reset()
        for i in range(SKIP):
            sess.add_frame_from_buffer(buf, i, seq.k, seq.frames[i].timestamp)
        sync(dev)
        t0 = time.perf_counter()
        for i in range(SKIP, n):
            sess.add_frame_from_buffer(buf, i, seq.k, seq.frames[i].timestamp)
        sync(dev)
        fps = (n - SKIP) / (time.perf_counter() - t0)
        sess.flush()
        counted(name, sess)
        return sess, fps

    sess, fps = timed_pass("image")
    poses, valid, _ = sess.trajectory()
    r = ate_mod.ate(poses[valid], gt[: len(valid)][valid])

    lc = LoopCloser(vocabulary.load_default(dev), cfg, device=dev)
    lc_sess, lc_fps = timed_pass("loop_closer", lc)
    lc_poses, lc_valid, _ = lc_sess.trajectory()
    lc_r = ate_mod.ate(lc_poses[lc_valid], gt[: len(lc_valid)][lc_valid])

    # overlapped ingest: 2 threads decode and upload frame i + depth while
    # the card steps frame i
    def overlapped_pass(depth: int = 6):
        sess = SlamSession(cfg, seed=1, run_ba=True, device=dev)
        sess.prewarm(image=True)
        side = torch.cuda.Stream(dev) if cuda else None

        def load(j):
            img = torch.from_numpy(seq.load_image(j))
            if not cuda:
                return img
            with torch.cuda.stream(side):
                x = img.pin_memory().to(dev, non_blocking=True)
            side.synchronize()
            return x

        if cuda:
            launches.reset()
        with ThreadPoolExecutor(2) as ex:
            futs = {i: ex.submit(load, i) for i in range(min(depth, n))}

            def get(i):
                img = futs.pop(i).result()
                if cuda:
                    img.record_stream(torch.cuda.current_stream(dev))
                if i + depth < n:
                    futs[i + depth] = ex.submit(load, i + depth)
                return img

            for i in range(SKIP):
                sess.add_frame(get(i), seq.k, seq.frames[i].timestamp)
            sync(dev)
            t0 = time.perf_counter()
            for i in range(SKIP, n):
                sess.add_frame(get(i), seq.k, seq.frames[i].timestamp)
            sync(dev)
            fps = (n - SKIP) / (time.perf_counter() - t0)
        sess.flush()
        counted("overlapped", sess)
        return fps

    ov_fps = overlapped_pass()
    details = {"decoded": imgs, "poses_gt": gt, "passes": passes, "lc_closures": lc.closures,
               "lc_reloc_attempts": lc_sess.reloc_attempts}
    return (fps, float(r.rmse), int(valid.sum()), n, warmup_s, ingest_ms, lc_fps, ov_fps,
            float(lc_r.rmse), details)


# --- the whole benchmark ----------------------------------------------------------------

def run(device="cuda", n_feat: int = 1000, n_frames: int = 60, wh=(640, 480),
        feature_frames: int = 40, world_points: int = 2500, n_rep: int = N_REP, root=None):
    """The benchmark at the given sizes (the defaults are `bench.py`'s).
    Returns (the JSON object with `bench.py`'s keys, details: each pass's
    launch counts, the fused chain's launches and links, its final state,
    the decoded frames)."""
    from monocular_slam_tpu_torch.datasets import synthetic
    from monocular_slam_tpu_torch.eval import ate
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils import prng
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    log("device:", label)

    # the reference's workload: 1000 features a frame, a 5-frame back-traverse,
    # an 8-frame local BA window
    cfg = SlamConfig(max_frames=64, max_points=20000, frontend=FrontendConfig(n_features=n_feat))
    seq = synthetic.feature_sequence(prng.PRNGKey(FEATURE_SEED), n_frames=feature_frames,
                                     n_world_points=world_points, n_features=n_feat,
                                     pix_noise=0.3, drop_prob=0.08, device=dev)
    t0 = time.perf_counter()
    sess = SlamSession(cfg, seed=1, run_ba=True, device=dev)
    sess.prewarm(image=False)
    tracked = 0
    for i, f in enumerate(seq.frames):
        st = sess.add_frame_features(f, seq.k, seq.timestamps[i])
        tracked += int(st.tracked)
    warmup_feat = time.perf_counter() - t0
    log(f"warmup+capture (feature path): {warmup_feat:.1f}s, tracked {tracked}/{feature_frames}")

    warm = sess.state
    i = feature_frames - 1
    dt, fused, links, fused_launches = bench_fused_step(cfg, warm, dev, i, n_rep)
    ba_ips, ba_dt, ba_chain = bench_ba_iters(cfg, warm, dev, i, n_rep)
    log(f"fused step {dt * 1e3:.2f} ms -> {1.0 / dt:.1f} fps; local BA {ba_dt * 1e3:.2f} ms "
        f"-> {ba_ips:.0f} LM iters/sec")
    rooflines = bench_rooflines(cfg, warm, dev, fused, ba_chain, dt, ba_dt, n_feat, wh)

    poses, valid, _ = sess.trajectory()
    r = ate.ate(poses[valid], np.asarray(seq.poses_gt)[valid])
    log(f"feature-path ATE {r.rmse * 1e3:.2f} mm")

    (img_fps, img_ate, img_tracked, img_n, warmup_img, ingest_ms, lc_fps, ov_fps, lc_ate,
     details) = bench_image_pipeline(n_feat, dev, n_frames, wh, root)
    log(f"image pipeline {img_fps:.1f} fps, ATE {img_ate * 100:.2f} cm, tracked "
        f"{img_tracked}/{img_n}, warmup {warmup_img:.1f}s, ingest {ingest_ms:.1f} ms/frame, "
        f"with-loop-closer {lc_fps:.1f} fps (ATE {lc_ate * 100:.2f} cm), overlapped-ingest "
        f"{ov_fps:.1f} fps")
    W, H = wh
    out = {
        "metric": f"image pipeline fps (ORB->track->BA, {W}x{H}, frames preloaded to the card "
                  "like the reference's FrameLoader preloads to RAM)",
        "value": img_fps,
        "unit": "fps",
        "vs_baseline": img_fps / REFERENCE_FPS_ESTIMATE,
        "baseline_note": "the reference's own estimate of 10 fps for its C++ ancestor "
                         "(bench.py REFERENCE_FPS_ESTIMATE; BASELINE.md), kept as it stands; both "
                         "sides exclude image load from the per-frame loop",
        "image_pipeline_ate_cm": img_ate * 100,
        "image_pipeline_tracked": f"{img_tracked}/{img_n}",
        "image_warmup_s": warmup_img,
        "ingest_ms_per_frame": ingest_ms,
        "ingest_overlapped_fps": ov_fps,
        "lc_fps": lc_fps,
        "lc_ate_cm": lc_ate * 100,
        "kernel_fps": 1.0 / dt,
        "kernel_ate_mm": r.rmse * 1e3,
        "kernel_tracked": f"{int(valid.sum())}/{len(valid)}",
        "ba_iters_per_sec": ba_ips,
        "warmup_s": warmup_feat,
        "device": label,
        "mfu": None,  # no cost model for the session step (see rooflines)
        "rooflines": rooflines,
    }
    details |= {"fused_launches": fused_launches, "fused_links": links, "n_rep": n_rep,
                "fused_state": fused.current(), "warm_state": warm, "fused_i": i,
                "ba_local_iters": cfg.ba.local_iters, "ba_s": ba_dt,
                "feature_tracked": tracked, "feature_frames": feature_frames}
    return out, details


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out, _ = run(args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
