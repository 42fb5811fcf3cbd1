"""Where the loop-closing session's time goes, on one NVIDIA GPU.

    python3 chip_profile.py          # the loop course, split by stage
    python3 chip_profile.py window   # the tracker's window: dense vs K2
    python3 chip_profile.py long [traj.npz]   # benchmarks/long_run.py's 1000 frames, by stage

`long`: `chip_smoke.run_long` over the full 1000 frames of the long-run
configuration, with every stage wrapped as below (the CG pose graph and the
CG global BA included). Prints the stage rows, then the run's summary, and
writes the trajectory (poses, valid, keyframes, closures) to `traj.npz`
when a path is given.

`window`: the 60-frame session of `chip_smoke.py` four times in one
process, the tracker's back-traverse window on the dense route, on K2, on
K2, on the dense route (fps over frames 10-59 each), then one more run of
each route with `tracker._window_matches` wrapped in
`torch.cuda.synchronize()` (ms per call). Prints one JSON object per line.

Without an argument:

Runs the `loop` course of `chip_smoke.py` (112 rendered 640x480 frames that
revisit the start, 8 frames of uniform noise after frame 40; max_frames 128,
max_points 20000, 1000 features, 8 levels, steer_mode "auto", BA on, the
bundled vocabulary) through `SlamSession` with a `LoopCloser`, and splits
the wall time by stage: each stage function is wrapped so that it starts
and ends with `torch.cuda.synchronize()`. The wrappers serialize the host
with the card, so the split adds up to more than the unwrapped run; the
unwrapped fps is measured first, in the same process. Before both, the
first and second calls of the library routines the loop closer adds
(`torch.func.jacfwd`, cuSOLVER's `det`, `svd`, `cholesky_ex`) are timed,
which also takes their one-time start-up out of the runs. After the run,
the closure's Sim3 is computed twice more. Prints one JSON object per
line; the last is the summary.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

LONG_RUN_FRAMES = 1000  # benchmarks/long_run.py's default

def _sync():
    torch.cuda.synchronize()


class StageTimer:
    """Wraps module or class attributes with synchronized timers."""

    def __init__(self):
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def timed(*a, **kw):
            _sync()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            _sync()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def stage_timer() -> StageTimer:
    """Every stage of the loop-closing session wrapped."""
    from monocular_slam_tpu_torch.geometry import alignment
    from monocular_slam_tpu_torch.ops import features, hamming
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.slam import keyframes, local_ba, loop_closer, mapping, tracker

    t = StageTimer()
    t.wrap(features, "extract", "extract (K1 inside)")
    t.wrap(tracker, "track", "tracker.track")
    t.wrap(tracker, "bootstrap", "tracker.bootstrap")
    t.wrap(local_ba, "local_bundle_adjust", "local BA")
    t.wrap(mapping, "fuse", "mapping.fuse")
    t.wrap(mapping, "cull_points", "mapping.cull_points")
    t.wrap(mapping, "frame_overlap", "mapping.frame_overlap")
    t.wrap(loop_closer, "detect_step", "loop_closer.detect_step")
    t.wrap(hamming, "match_kernel", "K2 match (window, compute_sim3, relocalize)")
    t.wrap(alignment, "ransac_sim3_reproj", "Sim3 RANSAC + polish")
    t.wrap(loop_closer.LoopCloser, "_correct_impl", "pose graph + propagation")
    t.wrap(pose_graph, "optimize_cg", "CG pose graph (inside pose graph + propagation)")
    t.wrap(loop_closer.LoopCloser, "_gba_impl", "global BA")
    t.wrap(cg_ba, "bundle_adjust_cg", "CG global BA (inside global BA)")
    t.wrap(keyframes, "cull_frames_device", "FrameCulling")
    t.wrap(tracker, "relocalize", "tracker.relocalize")
    return t


def print_stages(t: StageTimer, n: int, wall_ms: float) -> None:
    rows = sorted(((name, t.calls[name], ms) for name, ms in t.ms.items()), key=lambda r: -r[2])
    for name, calls, ms in rows:
        print(json.dumps({"stage": name, "calls": calls, "ms_total": ms, "ms_per_call": ms / calls,
                          "ms_per_frame": ms / n, "share": ms / wall_ms}), flush=True)


def long_run(smi: str, traj_path: str | None) -> int:
    import chip_smoke as cs

    t = stage_timer()
    try:
        _sync()
        t0 = time.perf_counter()
        out, sess = cs.run_long(LONG_RUN_FRAMES)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        t.restore()
    print_stages(t, out["frames"], wall_ms)
    print(json.dumps({"device": smi, "wrapped_wall_ms": wall_ms, **out}), flush=True)
    if traj_path:
        poses, valid, _ = sess.trajectory()
        np.savez_compressed(traj_path, poses=poses, valid=valid,
                            keyframes=np.asarray(sess._keyframes),
                            closures=np.asarray(sess.loop_closer.closures).reshape(-1, 2))
    return 0


def first_calls() -> dict:
    """First and second call, in a fresh process, of the library routines
    the loop closer adds: one-time start-up against steady cost (ms)."""
    dev = torch.device("cuda")
    x = torch.randn(256, 3, 3, device=dev)
    fns = {
        "torch.func.jacfwd": lambda: torch.func.jacfwd(torch.sin)(torch.ones(7, device=dev)),
        "linalg.det (256 3x3)": lambda: torch.linalg.det(x),
        "linalg.svd (256 3x3)": lambda: torch.linalg.svd(x),
        "linalg.cholesky_ex (896x896)": lambda: torch.linalg.cholesky_ex(torch.eye(896, device=dev)),
    }
    out = {}
    for name, fn in fns.items():
        ms = []
        for _ in range(2):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = ms
    return out


def window_ab(smi: str) -> int:
    import chip_smoke as cs
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.slam import tracker

    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH,
                                               device="cuda")
    cs.run_session(imgs, poses_gt, k, count_syncs=False)  # builds K1, K2; warms up
    fps = {"dense": [], "k2": []}
    for route in ("dense", "k2", "k2", "dense"):
        out = cs.run_session(imgs, poses_gt, k, count_syncs=False, dense_window=route == "dense")
        fps[route].append(out["fps_10_59"])
        print(json.dumps({"route": route, "fps_10_59": out["fps_10_59"], "ate_m": out["ate_m"],
                          "tracked": out["tracked"]}), flush=True)
    per_call = {}
    for route in ("dense", "k2"):
        t = StageTimer()
        if route == "dense":
            plain = tracker._window_matches
            tracker._window_matches = functools.partial(plain, use_kernel=False)
            t._undo.append((tracker, "_window_matches", plain))
        t.wrap(tracker, "_window_matches", "window")
        t.wrap(tracker, "track", "track")
        try:
            cs.run_session(imgs, poses_gt, k, count_syncs=False)
        finally:
            t.restore()
        per_call[route] = {n: t.ms[n] / t.calls[n] for n in t.ms}
    print(json.dumps({"device": smi, "fps_10_59": fps, "ms_per_call_synchronized": per_call}),
          flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[1:] == ["window"]:
        return window_ab(smi)
    if sys.argv[1:2] == ["long"]:
        return long_run(smi, sys.argv[2] if len(sys.argv) > 2 else None)
    print(json.dumps({"first_and_second_call_ms": first_calls()}), flush=True)
    fast_score.load()
    hamming.load()
    frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
    voc = vocabulary.load_default()

    plain, _ = cs.run_loop(frames, real, poses_gt, k, voc, "bundled")
    print(json.dumps({"unwrapped": {n: plain[n] for n in ("fps", "closures", "reloc_attempts",
                                                          "ate_m", "timings_s")}}), flush=True)

    t = stage_timer()
    try:
        _sync()
        t0 = time.perf_counter()
        out, sess = cs.run_loop(frames, real, poses_gt, k, voc, "bundled")
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        t.restore()
    n = frames.shape[0]
    print_stages(t, n, wall_ms)

    sim3_ms = []
    if out["closures"]:
        i, j = out["closures"][0]
        lc = sess.loop_closer
        for _ in range(2):
            _sync()
            t0 = time.perf_counter()
            with torch.inference_mode():
                lc.compute_sim3(sess.state, i, j, sess.gen)
            _sync()
            sim3_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"device": smi, "frames": n, "wrapped_wall_ms": wall_ms,
                      "wrapped_fps": n / wall_ms * 1e3, "unwrapped_fps": plain["fps"],
                      "closures": out["closures"], "reloc_attempts": out["reloc_attempts"],
                      "k2_launches": out["k2_launches"], "compute_sim3_again_ms": sim3_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
