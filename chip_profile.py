"""Where the loop-closing session's time goes, on one NVIDIA GPU.

    python3 chip_profile.py          # the loop course, split by stage
    python3 chip_profile.py window   # the tracker's window: dense vs K2
    python3 chip_profile.py long [traj.npz]   # benchmarks/long_run.py's 1000 frames, by stage
    python3 chip_profile.py cli      # the CLI on chip_smoke.py's cli course, by stage
    python3 chip_profile.py cgdense  # CG vs dense global BA on the loop state, by PCG steps
    python3 chip_profile.py cgdense long  # CG vs dense at every CG closure of the 1000-frame long run
    python3 chip_profile.py detsum [ROOT]  # the scale solvers and the session, package from ROOT
    python3 chip_profile.py fps [ROOT]     # the session's and the loop course's fps, package from ROOT
    python3 chip_profile.py nccl     # host cost of one all-reduce at NCCL world size 1
    python3 chip_profile.py k3ab [generator]  # key-3, loop, session and cli courses, eigh/svd on K3 or torch.linalg
    python3 chip_profile.py k3parent [ROOT]  # k3ab's parent's-calls route alone, package from ROOT
    python3 chip_profile.py k3 [ROOT]      # K3 alone at chip_smoke.py's K3 shapes, package from ROOT
    python3 chip_profile.py cgsteps  # chip_smoke.py's long phase at the reference's PCG steps and the port's
    python3 chip_profile.py cliproc  # the cli course in fresh processes and after other courses, frame by frame
    python3 chip_profile.py cliproc bisect [k3]  # the cli course after each step of k3ab's routes
    python3 chip_profile.py cliproc trace  # the closer's stages of the cli course after k3ab's routes
    python3 chip_profile.py drivers  # the ported drivers at full size (compile_profile cold first)
    python3 chip_profile.py capturegc  # which unreachable cycles a collection inside a capture breaks on

`cgdense`: the loop course of `chip_smoke.py`, then global BA on its
perturbed final state through the CG route at 50, 100, 200 and 400 PCG
steps against the dense route (the largest pose difference over the dense
route's largest move, and the scale of a Sim(3) fit of the CG keyframe
centres onto the dense ones), then the scale phase's `correct` comparison
with the CG pose graph at 100, 200, 300 and 400 PCG steps.

`cgdense long`: `benchmarks.long_run.run_long` over the full 1000 frames at the
reference's dense/CG switch of the pose graph (128 keyframes), keeping
the input of every call the loop closer routes to `pose_graph.optimize_cg`
(K_pad > 128) and to `cg_ba.bundle_adjust_cg` (F*P > 4e6) and its result;
then each input again through the dense route, `pose_graph.optimize` (the
(7 K_pad)^2 Cholesky, same iterations and Huber delta) and
`ba.bundle_adjust` (the dense Schur), and the two routes compared as the
loop state's check does: the largest pose-entry difference over the dense
route's largest pose move, and the 99th-percentile point difference over
the dense route's 99th-percentile point move.

`detsum [ROOT]`: the scale phase's two solvers (`chip_smoke.py`'s
10,000-keyframe CG pose graph and 1.5M-edge CG BA, 10 LM iterations, the
best of 3 calls after a warm-up) and the 60-frame session's fps over frames
10-59, with `monocular_slam_tpu_torch` imported from ROOT (default: this
checkout). Run it on two checkouts in one call to compare them on one card.

`fps [ROOT]`: the 60-frame session of `chip_smoke.py` twice (fps over
frames 10-59 of the second run) and its loop course once (fps, closures,
relocalization attempts), with `monocular_slam_tpu_torch` and
`chip_smoke.py` imported from ROOT (default: this checkout). Run it on two
checkouts in one call, in turns, to compare them on one card.

`k3 [ROOT]`: K3 alone on `chip_smoke._k3_inputs`' four inputs (eigh of
(1000, 4, 4) and (1, 12, 12), svd3 of (1, 3, 3) and (512, 3, 3)), with
`monocular_slam_tpu_torch` and `chip_smoke.py` imported from ROOT (default:
this checkout): per shape the median event-timed call over 50 (inference
mode) and the device ms per call from `torch.profiler` (every device
operation of the call) of the kernel and of `torch.linalg` on the same
input, and the kernel's largest value difference from `torch.linalg`
relative to the largest value. Run it on two checkouts in one call, in
turns, to compare them on one card.

`k3ab [generator]`: the committed key-3 fixture's course, the loop course,
the session's 60-frame course and the cli phase's course (the CLI run in
this process) of `chip_smoke.py`, each four ways: op by op with the
earlier calls (every site of `K3_SITES` swapped by `k3_sites`: `eigh`,
3x3 `svd` and `svdvals` on `torch.linalg`, every determinant by
`torch.linalg.det` in place of the closed form, and PnP's scale and
rotation as two calls, `scale_and_rotation_apart`); op by
op with `eigh` and `svd` sent to `torch.linalg` (cuSOLVER; it checks its
status on the host, so it cannot be captured);
op by op on K3, with every K3 call also run
through `torch.linalg` on the same input and the two held together
(eigenvalues relative to the largest, eigenvectors |<v, v_plain>| where the
eigengap exceeds 1e-3 of the largest, as `chip_smoke.py`'s k3 phase
does); and on K3 through the captured programs (the session's
route). Prints, per course and route, the outcome (closures, ATE, the
near-identity gate's drifts; or the distance from the reference's run)
and the calls' agreement; then the cli course in a fresh process
(`cliproc-child`), against which each route's cli run is compared as
`cliproc` compares its runs. With `generator` the loop course's noise frames
are the `torch.Generator` draw they were before the reference's threefry
draw replaced it.

`nccl`: a one-rank NCCL group in this process; 500 calls of
`distributed.all_reduce` on a (1000, 6) float32 tensor, host seconds per
call, on an idle card and queued behind a matmul chain of ~0.2 s (if a call
returns before the chain ends, it does not wait for the card), and
`torch.profiler`'s kernels and host events of 20 calls.

`cgsteps`: `benchmarks.long_run.run_long` (400 frames, switch at 128) twice in
one process, the loop closer's CG routes at the reference's PCG step
counts (50 for global BA, 100 for the pose graph) and at the port's
(`GLOBAL_BA_CG_ITERS`, `POSE_GRAPH_CG_ITERS`): tracked, ATE, closures,
closure stage seconds.

`cliproc`: `chip_smoke.py`'s cli course through `run.main` several ways,
to find where the outcome depends on the process: (a) twice as the smoke's
CLI subprocess (`--verbose`); (b) in fresh child processes
(`chip_profile.py cliproc-child ROOT OUT [--verbose]`) with and without
`--verbose`; (c) in this process, first with nothing before it, then after
the key-3 course, after the loop course and after the session course (as
`k3ab` runs them). Each run but (a) records, after every `add_frame`, bit
hashes of the input image, the frame's keypoints and descriptors, its
associations, its pose, every pose and the map (`frame_records`), and its
outcome rows. Prints, for each pair of runs, whether the trajectory files
are equal byte for byte and the first frame and field at which the
records differ.

`capturegc`: for each kind of object an unreachable reference cycle may
hold (`GARBAGE`: a `graph.Words` refilled once, a started
`graph.Readback`, a captured `graph.Program`, a recorded
`torch.cuda.Event`, a pinned tensor copied to the card, a device tensor),
a fresh child process (`capturegc-child KIND ROUTE`) makes the resource,
captures a program whose body hands it to a new unreachable reference
cycle, its only owner, and then allocates enough for the cyclic
collector (thresholds 1, 1, 1) to run inside the capture, and replays it. ROUTE `raw` captures with
`torch.cuda.graph` alone, `program` through `graph.Program`. Prints one
JSON object a case: whether the cycle was collected inside the capture,
whether the capture and its replay succeeded, and the error if not.

`cli`: `chip_smoke.py`'s cli course (200 frames of the long run's orbit
written as a TUM directory) through `run.main` in this process with every
stage wrapped as below, the PNG decode (`TumSequence.load_image`) too.
Prints the stage rows (shares of the CLI's own main-loop wall time), then
the CLI's summary.

`long`: `benchmarks.long_run.run_long` over the full 1000 frames of the long-run
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
and ends with `torch.cuda.synchronize()`, and each program replay is timed
under its program's kind (the step's "track" and "map", the closer's
"sim3", "correct", ...; a call made while a program is captured is not
timed: its replays are). The wrappers serialize the host
with the card, so the split adds up to more than the unwrapped run; the
unwrapped fps is measured first, in the same process. Before both, the
first and second calls of the library routines the loop closer adds
(`torch.func.jacfwd`, cuSOLVER's `det`, `svd`, `cholesky_ex`) are timed,
which also takes their one-time start-up out of the runs. After the run,
the closure's Sim3 is computed twice more. Prints one JSON object per
line; the last is the summary.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

LONG_RUN_FRAMES = 1000  # benchmarks/long_run.py's default

def _sync():
    torch.cuda.synchronize()


class StageTimer:
    """Wraps module or class attributes with synchronized timers. A call
    made while a step program is built (its warm-up run and its capture,
    inside `graph.Program`'s constructor) is not timed: the program's
    replays time those stages."""

    def __init__(self):
        from monocular_slam_tpu_torch.utils import graph

        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._undo = []
        self._building = 0
        build = graph.Program.__init__

        def building(prog, *a, **kw):
            self._building += 1
            try:
                build(prog, *a, **kw)
            finally:
                self._building -= 1

        graph.Program.__init__ = building
        self._undo.append((graph.Program, "__init__", build))

    def wrap(self, owner, attr: str, name: str):
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def timed(*a, **kw):
            if self._building:
                return orig(*a, **kw)  # inside a step program: timed by its replays
            _sync()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            _sync()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def wrap_replays(self):
        """Every program replay timed under its program's kind (the tracked
        step's "track" and "map", the loop closer's "sim3", "correct", ...)."""
        from monocular_slam_tpu_torch.utils import graph

        orig = graph.Program.replay

        def replay(prog):
            kind = getattr(prog, "key", ("program",))[0]
            name = f"program replays: {kind}"
            _sync()
            t0 = time.perf_counter()
            out = orig(prog)
            _sync()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        graph.Program.replay = replay
        self._undo.append((graph.Program, "replay", orig))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def stage_timer() -> StageTimer:
    """Every stage of the loop-closing session wrapped."""
    from monocular_slam_tpu_torch.geometry import alignment
    from monocular_slam_tpu_torch.ops import features, hamming
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.slam import keyframes, local_ba, loop_closer, mapping, session
    from monocular_slam_tpu_torch.slam import tracker

    t = StageTimer()
    t.wrap_replays()
    t.wrap(features, "extract", "extract (K1 inside)")
    t.wrap(tracker, "track", "tracker.track")
    t.wrap(tracker, "bootstrap", "tracker.bootstrap")
    t.wrap(session.SlamSession, "_untracked", "untracked frames (ingest; bootstrap)")
    t.wrap(session.SlamSession, "_try_relocalize", "relocalization attempts")
    t.wrap(session.SlamSession, "_cull_dispatch", "FrameCulling dispatch")
    t.wrap(loop_closer.LoopCloser, "compute_sim3", "Sim3 (program and read)")
    t.wrap(loop_closer.LoopCloser, "correct", "correction + global BA (programs and reads)")
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


def long_profile(smi: str, traj_path: str | None) -> int:
    from monocular_slam_tpu_torch.benchmarks import long_run

    t = stage_timer()
    try:
        _sync()
        t0 = time.perf_counter()
        out, sess = long_run.run_long(LONG_RUN_FRAMES)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        t.restore()
    print_stages(t, out["frames"], wall_ms)
    print(json.dumps({"device": smi, "wrapped_wall_ms": wall_ms,
                      **{n: v for n, v in out.items() if n not in ("poses", "valid", "poses_gt")}}),
          flush=True)
    if traj_path:
        poses, valid, _ = sess.trajectory()
        np.savez_compressed(traj_path, poses=poses, valid=valid,
                            keyframes=np.asarray(sess._keyframes),
                            closures=np.asarray(sess.loop_closer.closures).reshape(-1, 2))
    return 0


def cli_run(smi: str) -> int:
    import shutil
    import tempfile

    import chip_smoke as cs
    from monocular_slam_tpu_torch.datasets import tum

    work = tempfile.mkdtemp(prefix="chip_profile_cli_")
    try:
        course = cs.cli_course(work)
        t = stage_timer()
        t.wrap(tum.TumSequence, "load_image", "PNG decode (load_image)")
        try:
            summary, _ = cs._run_main_inprocess(cs.cli_args(course["root"], f"{work}/out"))
        finally:
            t.restore()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print_stages(t, cs.CLI_FRAMES, summary["wall_s"] * 1e3)
    print(json.dumps({"device": smi, **summary,
                      **{n: course[n] for n in ("render_s", "write_s", "decode_s")}}), flush=True)
    return 0


def cg_dense(smi: str) -> int:
    import chip_smoke as cs
    from monocular_slam_tpu_torch.eval.ate import umeyama_sim3
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.retrieval import vocabulary

    frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
    out, sess = cs.run_loop(frames, real, poses_gt, k, vocabulary.load_default(), "bundled")
    print(json.dumps({k: out[k] for k in ("closures", "corrected", "skipped_identity",
                                          "tracked_real", "ate_m")}), flush=True)
    lc, state = sess.loop_closer, sess.state
    valid = state.pose_valid.cpu().numpy()
    kfs = [f for f in sess._keyframes if valid[f]]
    pad = torch.zeros(state.poses.shape[0], dtype=torch.long, device="cuda")
    pad[: len(kfs)] = torch.as_tensor(kfs, device="cuda")
    poses = state.poses.clone()
    g = torch.Generator(device="cuda").manual_seed(3)
    poses[kfs[1:], :, 3] += 0.01 * torch.randn((len(kfs) - 1, 3), generator=g, device="cuda")
    st = state._replace(poses=poses)
    n = lc.lc.global_ba_iters

    def centres(s):
        p = s.poses[kfs].double()
        return (-(p[:, :, :3].transpose(1, 2) @ p[:, :, 3:])[..., 0]).cpu().numpy()

    with torch.inference_mode():
        dense = lc._gba_impl(st, pad, len(kfs), lc.global_ba_solver(cg=False))
        moved = (dense.poses - st.poses)[state.pose_valid].abs().max().item()
        for steps in (50, 100, 200, 400):
            cg = lc._gba_impl(st, pad, len(kfs), lambda pr: cg_ba.bundle_adjust_cg(
                pr, n_iters=n, max_cg_iters=steps))
            diff = (cg.poses - dense.poses)[state.pose_valid].abs().max().item()
            s_fit, _, _ = umeyama_sim3(centres(cg), centres(dense))
            print(json.dumps({"global_ba_pcg_steps": steps, "max_pose_diff_m": diff,
                              "dense_moved_pose_m": moved, "ratio": diff / moved,
                              "sim3_scale_cg_to_dense": s_fit}), flush=True)
    plain = pose_graph.optimize_cg
    try:
        for steps in (100, 200, 300, 400):
            pose_graph.optimize_cg = lambda gr, steps=steps, **kw: plain(
                gr, **{**kw, "max_cg_iters": steps})
            row = cs._cg_vs_dense(sess, out["closures"][0])["correct"]
            print(json.dumps({"pose_graph_pcg_steps": steps, "pose_ratio": row["max_pose_diff_m"]
                              / row["dense_moved_pose_m"], "p99_point_ratio":
                              row["p99_point_diff_m"] / row["dense_moved_p99_point_m"], **row}),
                  flush=True)
    finally:
        pose_graph.optimize_cg = plain
    print(json.dumps({"device": smi}), flush=True)
    return 0


def cg_dense_long(smi: str) -> int:
    import chip_smoke as cs
    from monocular_slam_tpu_torch.benchmarks import long_run
    from monocular_slam_tpu_torch.optim import ba, cg_ba, pose_graph

    kept = {"optimize_cg": [], "bundle_adjust_cg": []}
    plain = pose_graph.optimize_cg, cg_ba.bundle_adjust_cg

    def keep(name, fn):
        def solve(x, *a, **kw):
            res = fn(x, *a, **kw)
            kept[name].append((x, kw, res))
            return res
        return solve

    pose_graph.optimize_cg = keep("optimize_cg", plain[0])
    cg_ba.bundle_adjust_cg = keep("bundle_adjust_cg", plain[1])
    try:
        with cs.reference_pose_graph_switch():
            out, sess = long_run.run_long(LONG_RUN_FRAMES)
    finally:
        pose_graph.optimize_cg, cg_ba.bundle_adjust_cg = plain
    print(json.dumps({k: out[k] for k in ("frames", "tracked", "ate_m", "closures", "corrected")}),
          flush=True)

    def ratio(diff, moved):
        return diff / moved if moved > 0 else float("inf")

    rows = []
    with torch.inference_mode():
        for g, kw, res in kept["optimize_cg"]:
            _sync()
            t0 = time.perf_counter()
            dense = pose_graph.optimize(g, n_iters=kw.get("n_iters", 20),
                                        huber_delta=kw.get("huber_delta"))
            _sync()
            moved = (dense.vertices - g.vertices).abs().max().item()
            diff = (res.vertices - dense.vertices).abs().max().item()
            row = {"route": "pose_graph", "K_pad": int(g.vertices.shape[0]),
                   "edges": int(g.valid.sum()), "pcg_steps": kw.get("max_cg_iters"),
                   "dense_s": time.perf_counter() - t0, "max_pose_diff": diff,
                   "dense_moved_pose": moved, "pose_ratio": ratio(diff, moved),
                   "chi2_cg": float(res.chi2_history[-1]),
                   "chi2_dense": float(dense.chi2_history[-1])}
            rows.append(row)
            print(json.dumps(row), flush=True)
        for pr, kw, res in kept["bundle_adjust_cg"]:
            _sync()
            t0 = time.perf_counter()
            dense = ba.bundle_adjust(pr, n_iters=kw.get("n_iters", ba.FULL_BA_ITER))
            _sync()
            obs = torch.zeros(pr.points.shape[0], dtype=torch.bool, device=pr.points.device)
            obs[pr.pt_idx[pr.valid].long()] = True
            free = ~pr.fixed
            moved_p = (dense.poses - pr.poses)[free].abs().max().item()
            diff_p = (res.poses - dense.poses)[free].abs().max().item()
            moved_x = torch.linalg.norm(dense.points - pr.points, dim=-1)[obs]
            diff_x = torch.linalg.norm(res.points - dense.points, dim=-1)[obs]
            q = torch.tensor([0.99], dtype=moved_x.dtype, device=moved_x.device)
            p99_moved, p99_diff = torch.quantile(moved_x, q).item(), torch.quantile(diff_x, q).item()
            row = {"route": "global_ba", "F": int(pr.poses.shape[0]), "P": int(pr.points.shape[0]),
                   "edges": int(pr.valid.sum()), "pcg_steps": kw.get("max_cg_iters"),
                   "dense_s": time.perf_counter() - t0, "max_pose_diff": diff_p,
                   "dense_moved_pose": moved_p, "pose_ratio": ratio(diff_p, moved_p),
                   "p99_point_diff": p99_diff, "dense_moved_p99_point": p99_moved,
                   "p99_point_ratio": ratio(p99_diff, p99_moved),
                   "chi2_cg": float(res.chi2_history[-1]),
                   "chi2_dense": float(dense.chi2_history[-1])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    pg_sweep(kept["optimize_cg"])
    f_pose, f_point = cs.CG_VS_DENSE_FRAC
    bad = [r for r in rows if r["pose_ratio"] > f_pose or r.get("p99_point_ratio", 0) > f_point]
    print(json.dumps({"device": smi, "cg_calls": {k: len(v) for k, v in kept.items()},
                      "rule": {"pose": f_pose, "p99_point": f_point},
                      "worst_pose_ratio": max((r["pose_ratio"] for r in rows), default=None),
                      "worst_p99_point_ratio": max((r.get("p99_point_ratio", 0) for r in rows),
                                                   default=None),
                      "failing_rule": len(bad)}), flush=True)
    return 0


def pg_sweep(kept) -> None:
    """The CG pose graph on the first, a middle and the last of the long
    run's CG graphs at more PCG steps (fixed trip counts), and float64 at
    the closer's count on the last graph. Per run:
    seconds, PCG steps run over the 20 LM iterations, the pose ratio to the
    dense route."""
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.slam.loop_closer import POSE_GRAPH_CG_ITERS

    steps_run = []
    plain_pcg = cg_ba.pcg

    def counted(*a, **kw):
        x, stats = plain_pcg(*a, **kw)
        steps_run.append(stats.n_iters)
        return x, stats

    picks = sorted({0, len(kept) // 2, len(kept) - 1}) if kept else []
    cg_ba.pcg = counted
    try:
        with torch.inference_mode():
            for n, idx in enumerate(picks):
                g, kw, _ = kept[idx]
                dense = pose_graph.optimize(g, n_iters=kw.get("n_iters", 20),
                                            huber_delta=kw.get("huber_delta"))
                moved = (dense.vertices - g.vertices).abs().max().item()
                variants = [(f"fixed {m}", g, dict(kw, max_cg_iters=m)) for m in (400, 800, 1600)]
                if idx == picks[-1]:
                    variants.append((f"float64 {POSE_GRAPH_CG_ITERS}", g._replace(
                        vertices=g.vertices.double(), meas=g.meas.double(),
                        weight=g.weight.double()), dict(kw, max_cg_iters=POSE_GRAPH_CG_ITERS)))
                for name, gv, kv in variants:
                    steps_run.clear()
                    _sync()
                    t0 = time.perf_counter()
                    res = pose_graph.optimize_cg(gv, **kv)
                    _sync()
                    dt = time.perf_counter() - t0
                    diff = (res.vertices.float() - dense.vertices).abs().max().item()
                    print(json.dumps({"sweep": name, "K_pad": int(g.vertices.shape[0]),
                                      "edges": int(g.valid.sum()), "s": dt,
                                      "pcg_steps_run": int(sum(int(v) for v in steps_run)),
                                      "pose_ratio": diff / moved,
                                      "chi2": float(res.chi2_history[-1]),
                                      "chi2_dense": float(dense.chi2_history[-1])}), flush=True)
    finally:
        cg_ba.pcg = plain_pcg


def nccl_cost(smi: str) -> int:
    import chip_smoke as cs
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from monocular_slam_tpu_torch.parallel import distributed
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{cs._free_port()}",
                            world_size=1, rank=0)
    try:
        group = make_mesh(1).get_group("model")
        x = torch.randn(1000, 6, device="cuda")
        a = torch.randn(4096, 4096, device="cuda")
        out = {"device": smi}
        for _ in range(20):
            distributed.all_reduce(group, x)
        _sync()
        t0 = time.perf_counter()
        for _ in range(500):
            distributed.all_reduce(group, x)
        out["idle_host_ms_per_call"] = (time.perf_counter() - t0) / 500 * 1e3
        _sync()
        t0 = time.perf_counter()
        for _ in range(100):
            a = a @ a
            a = a / a.norm()
        chain_s = time.perf_counter() - t0
        _sync()
        out["chain_alone_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(100):
            a = a @ a
            a = a / a.norm()
        t1 = time.perf_counter()
        for _ in range(500):
            distributed.all_reduce(group, x)
        t2 = time.perf_counter()
        _sync()
        t3 = time.perf_counter()
        out |= {"chain_enqueue_s": chain_s, "busy_host_ms_per_call": (t2 - t1) / 500 * 1e3,
                "busy_calls_returned_before_chain_end": t2 < t0 + out["chain_alone_s"],
                "busy_total_s": t3 - t0}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                distributed.all_reduce(group, x)
            _sync()
        cuda = torch.autograd.DeviceType.CUDA
        out["profile_20_calls"] = sorted(
            [(e.key, e.count, round(e.cpu_time_total / 1e3, 3), e.device_type == cuda)
             for e in prof.key_averages()], key=lambda r: -r[2])[:15]
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def det_sum(smi: str, root: str | None) -> int:
    if root:
        sys.path.insert(0, root)
    import chip_smoke as cs
    import monocular_slam_tpu_torch
    from monocular_slam_tpu_torch.benchmarks import kitti_scale
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    fast_score.load()
    hamming.load()
    out = {"package": monocular_slam_tpu_torch.__file__}
    g = kitti_scale.pose_graph_problem(cs.SCALE_KF, cs.SCALE_LOOPS, "cuda")
    prob, _ = kitti_scale.ba_problem(*cs.SCALE_BA, "cuda")
    for name, fn in (("pose_graph_cg_s_per_lm_iter",
                      lambda: pose_graph.optimize_cg(g, n_iters=cs.SCALE_ITERS)),
                     ("global_ba_cg_s_per_lm_iter",
                      lambda: cg_ba.bundle_adjust_cg(prob, n_iters=cs.SCALE_ITERS, max_cg_iters=50))):
        fn()
        times = [kitti_scale.timed_solve(fn)[1] / cs.SCALE_ITERS for _ in range(3)]
        out[name] = min(times)
        out[name + "_all"] = times
    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH, device="cuda")
    run = cs.run_session(imgs, poses_gt, k, count_syncs=False)
    out |= {"session_fps_10_59": run["fps_10_59"], "session_ate_m": run["ate_m"]}
    print(json.dumps({"device": smi, **out}), flush=True)
    return 0


def fps_run(smi: str, root: str | None) -> int:
    if root:
        sys.path.insert(0, root)
    import chip_smoke as cs
    import monocular_slam_tpu_torch
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    fast_score.load()
    hamming.load()
    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH, device="cuda")
    cs.run_session(imgs, poses_gt, k, count_syncs=False)
    run = cs.run_session(imgs, poses_gt, k, count_syncs=False)
    frames, real, loop_gt, loop_k = cs._loop_frames(torch.device("cuda"))
    loop, _ = cs.run_loop(frames, real, loop_gt, loop_k, vocabulary.load_default(), "bundled")
    print(json.dumps({"device": smi, "package": monocular_slam_tpu_torch.__file__,
                      "session_fps_10_59": run["fps_10_59"], "session_tracked": run["tracked"],
                      "session_ate_m": run["ate_m"], "loop_fps": loop["fps"],
                      "loop_closures": loop["closures"], "loop_reloc_attempts": loop["reloc_attempts"],
                      "loop_ate_m": loop["ate_m"]}), flush=True)
    return 0


def k3_run(smi: str, root: str | None) -> int:
    if root:
        sys.path.insert(0, root)
    import chip_smoke as cs
    import monocular_slam_tpu_torch
    from monocular_slam_tpu_torch.ops import small_eigh
    from torch.profiler import ProfilerActivity, profile

    def device_ms_per_call(fn, n: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                 for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / n / 1e3

    small_eigh.load()
    out = {"device": smi, "package": monocular_slam_tpu_torch.__file__}
    for name, x in cs._k3_inputs("cuda").items():
        if name.startswith("eigh"):
            fns = {"kernel": lambda x=x: small_eigh.eigh(x),
                   "torch.linalg": lambda x=x: small_eigh.eigh_plain(x)}
        else:
            fns = {"kernel": lambda x=x: small_eigh.svd3(x),
                   "torch.linalg": lambda x=x: small_eigh.svd3_plain(x)}
        with torch.inference_mode():
            vals = [f()[0 if name.startswith("eigh") else 1] for f in fns.values()]
        scale = vals[1].abs().amax(-1, keepdim=True)
        row = {"max_value_rel_err": {label: float(((v - vals[1]).abs() / scale).max())
                                     for label, v in zip(fns, vals)}}
        for label, fn in fns.items():
            row[label] = {"ms": cs.time_ms_inference(fn), "device_ms": device_ms_per_call(fn)}
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


def cg_steps(smi: str) -> int:
    import chip_smoke as cs
    from monocular_slam_tpu_torch.benchmarks import long_run
    from monocular_slam_tpu_torch.slam import loop_closer

    port = loop_closer.GLOBAL_BA_CG_ITERS, loop_closer.POSE_GRAPH_CG_ITERS
    try:
        for steps in ((50, 100), port):
            loop_closer.GLOBAL_BA_CG_ITERS, loop_closer.POSE_GRAPH_CG_ITERS = steps
            with cs.reference_pose_graph_switch():
                out, _ = long_run.run_long(cs.LONG_FRAMES)
            print(json.dumps({"pcg_steps_global_ba_pose_graph": steps,
                              **{k: out[k] for k in ("tracked", "ate_m", "fps", "closures",
                                                     "corrected", "closure_s_per_run")},
                              "routes": {f"{stage}_{route}": sum(r.get(stage) == route
                                                                 for r in out["routes"])
                                         for stage in ("pose_graph", "global_ba")
                                         for route in ("dense", "cg")}}),
                  flush=True)
    finally:
        loop_closer.GLOBAL_BA_CG_ITERS, loop_closer.POSE_GRAPH_CG_ITERS = port
    print(json.dumps({"device": smi}), flush=True)
    return 0


# Every site through which the step reaches a decomposition that K3 took
# over, by kind: the attribute every caller looks up at call time, and each
# module global bound at import. The k3ab routes swap all of a kind's sites
# at once (`k3_sites`); tests/test_torch_k3.py walks the package and fails
# on a binding missing here.
K3_SITES = {
    "eigh": (("monocular_slam_tpu_torch.ops.small_eigh", "eigh"),),
    "svd3": (("monocular_slam_tpu_torch.ops.small_eigh", "svd3"),),
    "svdvals3": (("monocular_slam_tpu_torch.ops.small_eigh", "svdvals3"),),
    "det3x3": (("monocular_slam_tpu_torch.utils.linalg", "det3x3"),
               ("monocular_slam_tpu_torch.geometry.so3", "det3x3"),
               ("monocular_slam_tpu_torch.geometry.epipolar", "det3x3"),
               ("monocular_slam_tpu_torch.geometry.alignment", "det3x3")),
    # PnP's scale and rotation: one svd3 on a card, two calls in the reference
    "pnp_scale_and_rotation": (("monocular_slam_tpu_torch.geometry.pnp", "scale_and_rotation"),),
}


@contextlib.contextmanager
def k3_sites(missing_ok: bool = False, **fns):
    """Every site of each kind named (`K3_SITES`) bound to the function
    given for it, for the duration; all restored after. With `missing_ok`
    (an earlier tree's package) a site that tree lacks is left out. Every
    site's module is imported before the first swap: a module imported for
    the first time inside the swap would bind the swapped function by name
    (`from ... import det3x3`) and keep it after the restore."""
    import importlib

    mods = {mod: importlib.import_module(mod) for kind in fns for mod, _ in K3_SITES[kind]}
    undo = []
    try:
        for kind, fn in fns.items():
            for mod, attr in K3_SITES[kind]:
                m = mods[mod]
                if missing_ok and not hasattr(m, attr):
                    continue
                undo.append((m, attr, getattr(m, attr)))
                setattr(m, attr, fn)
        yield
    finally:
        for m, attr, orig in reversed(undo):
            setattr(m, attr, orig)


def parent_calls() -> dict:
    """The k3ab route "the parent's calls": eigh, svd and svdvals on
    `torch.linalg`, determinants by `torch.linalg.det`, PnP's scale and
    rotation as two calls (where the package has the site)."""
    from monocular_slam_tpu_torch.geometry import pnp
    from monocular_slam_tpu_torch.ops import small_eigh

    fns = dict(eigh=small_eigh.eigh_plain, svd3=small_eigh.svd3_plain,
               svdvals3=torch.linalg.svdvals, det3x3=torch.linalg.det)
    if hasattr(pnp, "scale_and_rotation_apart"):
        fns["pnp_scale_and_rotation"] = pnp.scale_and_rotation_apart
    return fns


def k3_parent(smi: str, root: str | None) -> int:
    """`k3parent [ROOT]`: the route "the parent's calls" alone, op by op, on
    the key-3 and loop courses, with `monocular_slam_tpu_torch` and
    `chip_smoke.py` imported from ROOT (an earlier tree: the sites it has)."""
    if root:
        sys.path.insert(0, root)
    import chip_smoke as cs
    import monocular_slam_tpu_torch
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
    with k3_sites(missing_ok=True, **parent_calls()):
        key3, _, _ = cs.run_key3_course(eager=True)
        loop, _ = cs.run_loop(frames, real, poses_gt, k, vocabulary.load_default(), "bundled",
                              eager=True)
    print(json.dumps({
        "device": smi, "package": monocular_slam_tpu_torch.__file__,
        "key3": {m: key3[m] for m in ("rot_max_diff", "trans_max_rel_diff", "n_inliers_max_diff")},
        "loop": {m: loop.get(m) for m in ("tracked_real", "ate_m", "closures", "corrected",
                                          "skipped_identity", "gate_drifts")}}), flush=True)
    return 0


@contextlib.contextmanager
def op_by_op_sessions():
    """Every `SlamSession` made meanwhile runs its functions op by op
    (`_use_graphs` cleared; the CLI makes its own session)."""
    from monocular_slam_tpu_torch.slam import session

    init = session.SlamSession.__init__

    def eager_init(self, *a, **kw):
        init(self, *a, **kw)
        self._use_graphs = False

    session.SlamSession.__init__ = eager_init
    try:
        yield
    finally:
        session.SlamSession.__init__ = init


def generator_noise(dev) -> torch.Tensor:
    """The loop course's noise frames as chip_smoke.py drew them before they
    became the reference's threefry draw (a `torch.Generator` seeded 40)."""
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(40)
    return torch.floor(255.0 * torch.rand((cs.BLACKOUT, cs.WH[1], cs.WH[0]), generator=g,
                                          device=dev))


def k3_ab(smi: str, generator: bool = False) -> int:
    import shutil
    import tempfile

    import chip_smoke as cs

    if generator:  # the loop course before its threefry noise
        cs.loop_noise = generator_noise
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import small_eigh
    from monocular_slam_tpu_torch.retrieval import vocabulary

    kernel_eigh, kernel_svd3 = small_eigh.eigh, small_eigh.svd3
    agree = {}

    def note(name, shape, val_err, dot):
        row = agree.setdefault(name, {"calls": 0, "n": set(), "max_batch": 0,
                                      "max_value_rel_err": 0.0, "min_vector_dot": 1.0})
        row["calls"] += 1
        row["n"].add(int(shape[-1]))
        row["max_batch"] = max(row["max_batch"], math.prod(shape[:-2]))
        row["max_value_rel_err"] = max(row["max_value_rel_err"], val_err)
        if dot is not None:
            row["min_vector_dot"] = min(row["min_vector_dot"], dot)

    def checked_eigh(A):
        w, V = kernel_eigh(A)
        if A.numel():
            wp, Vp = small_eigh.eigh_plain(A)
            scale = wp.abs().amax(-1, keepdim=True).clamp_min(1e-30)
            note("eigh", A.shape, float(((w - wp).abs() / scale).max()),
                 cs._vec_agreement(V, Vp, wp))
        return w, V

    def checked_svd3(M):
        U, S, Vt = kernel_svd3(M)
        if M.numel():
            Up, Sp, Vtp = small_eigh.svd3_plain(M)
            scale = Sp.amax(-1, keepdim=True).clamp_min(1e-30)
            dots = [d for d in (cs._vec_agreement(U, Up, Sp), cs._vec_agreement(Vt.mT, Vtp.mT, Sp))
                    if d is not None]
            note("svd3", M.shape, float(((S - Sp).abs() / scale).max()), min(dots, default=None))
        return U, S, Vt

    routes = {  # (sites swapped, op by op)
        "the parent's calls (torch.linalg eigh, svd, svdvals, det; PnP's scale and rotation "
        "apart), op by op": (parent_calls(), True),
        "torch.linalg, op by op": (dict(eigh=small_eigh.eigh_plain, svd3=small_eigh.svd3_plain),
                                   True),
        "K3 checked against torch.linalg, op by op": (dict(eigh=checked_eigh, svd3=checked_svd3),
                                                      True),
        "K3, captured programs": ({}, False),
    }
    frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
    imgs, s_gt, s_k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH, device="cuda")
    voc = vocabulary.load_default()
    work = tempfile.mkdtemp(prefix="chip_profile_k3ab_")
    try:
        course = cs.cli_course(work)
        for n, (route, (fns, eager)) in enumerate(routes.items()):
            agree.clear()
            with k3_sites(**fns), (op_by_op_sessions() if eager else contextlib.nullcontext()):
                key3, _, _ = cs.run_key3_course(eager=eager)
                loop, _ = cs.run_loop(frames, real, poses_gt, k, voc, "bundled", eager=eager)
                sess = cs.run_session(imgs, s_gt, s_k, count_syncs=False, eager=eager)
                cli = recorded_cli(course["root"], f"{work}/out{n}", False)
            print(json.dumps({
                "route": route,
                "key3": {m: key3[m] for m in ("tracked_equal", "keyframes_equal", "key_equal",
                                              "n_inliers_max_diff", "rot_max_diff",
                                              "trans_max_rel_diff")},
                "loop": {m: loop[m] for m in ("tracked_real", "ate_m", "closures", "corrected",
                                              "skipped_identity", "reverted", "reloc_attempts",
                                              "gate_drifts")},
                "session": {m: sess[m] for m in ("tracked", "ate_m", "keyframes")},
                "cli": {m: cli.get(m) for m in ("tracked", "ate_rmse", "loop_closures")},
                # over the four courses' calls
                "k3_against_torch_linalg": {m: {**r, "n": sorted(r["n"])} for m, r in agree.items()},
            }), flush=True)
        # the cli course in a fresh process, against each route's run in this one
        fresh = os.path.join(work, "fresh")
        proc = subprocess.run([sys.executable, str(cs.ROOT / "chip_profile.py"), "cliproc-child",
                               course["root"], fresh], capture_output=True, text=True,
                              cwd=str(cs.ROOT), timeout=cs.CLI_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"fresh cli child: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        print(json.dumps({"fresh process cli": json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
        traj = open(os.path.join(fresh, "trajectory.txt"), "rb").read()
        for n, route in enumerate(routes):
            out = f"{work}/out{n}"
            print(json.dumps({"route": route, "cli_against_a_fresh_process": {
                "trajectory_equal": open(os.path.join(out, "trajectory.txt"), "rb").read() == traj,
                **_first_difference(out, fresh)}}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"device": smi}), flush=True)
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


RECORD_FIELDS = ("image", "keypoints", "descriptors", "associations", "pose", "poses", "map")


def _bit_hash(t: torch.Tensor) -> torch.Tensor:
    """An int64 hash of a tensor's bits, on its device (no host read); a
    float's NaNs hash as one NaN and -0 as +0 (values, not payloads)."""
    t = t.detach().reshape(-1)
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.nan, t + 0.0)
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    elif t.dtype == torch.float64:
        t = t.view(torch.int64)
    x = t.to(torch.int64)
    w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) * 2654435761 + 1
    return (x * w).sum()


@contextlib.contextmanager
def frame_records(rows: list):
    """After every `SlamSession.add_frame`, one int64 row of `RECORD_FIELDS`
    bit hashes appended to `rows` (device tensors)."""
    from monocular_slam_tpu_torch.slam import session

    add = session.SlamSession.add_frame

    def recorded(self, img, *a, **kw):
        out = add(self, img, *a, **kw)
        st, i = self.state, self._next - 1
        slot = st.slot_of[i].clamp_min(0).long()
        im = torch.as_tensor(np.ascontiguousarray(img)) if not torch.is_tensor(img) else img
        rows.append(torch.stack([
            _bit_hash(im.to(st.poses.device)), _bit_hash(st.kp_uv[slot]),
            _bit_hash(st.desc[slot]), _bit_hash(st.feat_point[slot]),
            _bit_hash(st.poses[i]) + _bit_hash(st.pose_valid[i]),
            _bit_hash(st.poses) + _bit_hash(st.pose_valid),
            _bit_hash(st.points * st.point_valid[:, None]) + _bit_hash(st.n_points)]))
        return out

    sessions = []
    init = session.SlamSession.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        sessions.append(self)

    session.SlamSession.add_frame = recorded
    session.SlamSession.__init__ = keep
    try:
        yield sessions
    finally:
        session.SlamSession.add_frame = add
        session.SlamSession.__init__ = init


OUTCOME_FIELDS = ("tracked", "n_inliers", "n_new_points", "n_fused", "n_culled", "is_keyframe",
                  "chi2_before", "chi2_after", "cand_j", "cand_score")


def recorded_cli(root: str, out: str, verbose: bool) -> dict:
    """`run.main` on the cli course under `frame_records`; writes
    OUT/records.npz (the hashes, the outcome rows, the closures) and returns
    the summary."""
    import chip_smoke as cs

    rows: list = []
    with frame_records(rows) as sessions:
        summary, _ = cs._run_main_inprocess(cs.cli_args(root, out) + (["--verbose"] if verbose
                                                                      else []))
    sess = sessions[-1]
    outcomes = np.array([[float(getattr(s, n)) for n in OUTCOME_FIELDS] for s in sess.stats])
    np.savez(os.path.join(out, "records.npz"), hashes=torch.stack(rows).cpu().numpy(),
             outcomes=outcomes, closures=np.asarray(summary.get("loop_closures", [])).reshape(-1, 2))
    return summary


def _first_difference(a: str, b: str) -> dict:
    """Where two runs' records first differ: the frame and the fields of
    its hash row, or the first outcome row and its fields."""
    with np.load(os.path.join(a, "records.npz")) as fa, np.load(os.path.join(b, "records.npz")) as fb:
        ha, hb, oa, ob = fa["hashes"], fb["hashes"], fa["outcomes"], fb["outcomes"]
    out = {"hash_rows": [len(ha), len(hb)]}
    n = min(len(ha), len(hb))
    bad = np.nonzero((ha[:n] != hb[:n]).any(1))[0]
    if len(bad):
        f = int(bad[0])
        out["first_frame"] = f
        out["fields"] = [RECORD_FIELDS[c] for c in np.nonzero(ha[f] != hb[f])[0]]
    m = min(len(oa), len(ob))
    bad = np.nonzero(((oa[:m] != ob[:m]) & ~(np.isnan(oa[:m]) & np.isnan(ob[:m]))).any(1))[0]
    if len(bad):
        f = int(bad[0])
        out["first_outcome_frame"] = f
        out["outcome_fields"] = {OUTCOME_FIELDS[c]: [oa[f, c], ob[f, c]]
                                 for c in np.nonzero(oa[f] != ob[f])[0]}
    return out


def cliproc_child(argv) -> int:
    """`cliproc-child ROOT OUT [--verbose | --eager]`: one recorded CLI run
    in a fresh process (with `--eager`, its session op by op)."""
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    if argv[2:] == ["--trace"]:
        summary = traced_cli(argv[0], argv[1])
    else:
        with op_by_op_sessions() if argv[2:] == ["--eager"] else contextlib.nullcontext():
            summary = recorded_cli(argv[0], argv[1], argv[2:] == ["--verbose"])
    print(json.dumps(summary), flush=True)
    return 0


class _Holder:
    """A bare object to hang CUDA resources and reference cycles on."""


def _resource(kind: str) -> _Holder:
    """An object holding one `kind` of CUDA resource (see `capturegc`),
    used once on the card and in no reference cycle."""
    from monocular_slam_tpu_torch.utils import graph

    h = _Holder()
    dev = torch.device("cuda")
    if kind == "words":
        h.res = graph.Words(4, dev)
        h.res.fill(np.arange(4))
    elif kind == "readback":
        h.res = graph.Readback(4, dev).start()
    elif kind == "program":
        x = torch.zeros(8, device=dev)
        h.res = graph.Program(lambda: x.add_(1), stream=torch.cuda.Stream(dev))
    elif kind == "event":
        h.res = torch.cuda.Event()
        h.res.record()
    elif kind == "pinned":
        h.res = torch.arange(256, dtype=torch.float32).pin_memory()
        h.dev = torch.empty(256, device=dev)
        h.dev.copy_(h.res, non_blocking=True)
    elif kind == "tensor":
        h.res = torch.ones(1 << 20, device=dev)
    else:
        raise ValueError(kind)
    torch.cuda.synchronize()
    return h


GARBAGE = ("words", "readback", "program", "event", "pinned", "tensor")


def capturegc_child(kind: str, route: str) -> int:
    """`capturegc-child KIND ROUTE`: one case of `capturegc`."""
    import gc
    import weakref

    from monocular_slam_tpu_torch.utils import graph

    dev = torch.device("cuda")
    x = torch.arange(1024, dtype=torch.float32, device=dev)
    pending = [_resource(kind)]
    ref = weakref.ref(pending[0])
    seen = {}

    def body():
        y = x * 2.0
        if graph.capturing():
            cycle = _Holder()  # a young cycle, the resource's only owner, unreachable
            cycle.me, cycle.res = cycle, pending.pop()
            del cycle
            junk = [[i] for i in range(2000)]  # the collector may run during these
            del junk
            seen["collected_in_capture"] = ref() is None
        return y + 1.0

    body()
    torch.cuda.synchronize()
    gc.set_threshold(1, 1, 1)
    out = {"kind": kind, "route": route}
    try:
        if route == "raw":
            g, s = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
            with torch.cuda.graph(g, stream=s):
                y = body()
            g.replay()
        else:
            prog = graph.Program(body, stream=torch.cuda.Stream(dev))
            y = prog.replay()
        torch.cuda.synchronize()
        out.update(ok=bool(torch.equal(y, x * 2.0 + 1.0)), error=None)
    except Exception as e:  # noqa: BLE001 (the case's outcome is what it reports)
        out.update(ok=False, error=f"{type(e).__name__}: {str(e).splitlines()[0]}")
    gc.set_threshold(700, 10, 10)
    out.update(seen)
    print(json.dumps(out), flush=True)
    return 0


def capture_gc(smi: str) -> int:
    """`capturegc`: every kind of `GARBAGE` on both routes, a child each."""
    rows = []
    for kind in GARBAGE:
        for route in ("raw", "program"):
            r = subprocess.run([sys.executable, __file__, "capturegc-child", kind, route],
                               capture_output=True, text=True, timeout=300)
            lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
            row = json.loads(lines[-1]) if lines else {
                "kind": kind, "route": route, "ok": False,
                "error": f"exit {r.returncode}: {r.stderr.strip().splitlines()[-1:]}"}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"device": smi, "capturegc": rows}), flush=True)
    return 0


def cli_proc(smi: str) -> int:
    import itertools
    import shutil
    import tempfile

    import chip_smoke as cs
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.retrieval import vocabulary

    work = tempfile.mkdtemp(prefix="chip_profile_cliproc_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(cs.ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    runs: dict[str, dict] = {}
    try:
        course = cs.cli_course(work)
        root = course["root"]

        def child(name, cmd):
            out = os.path.join(work, name)
            proc = subprocess.run(cmd(out), capture_output=True, text=True, env=env,
                                  cwd=str(cs.ROOT), timeout=cs.CLI_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"{name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            runs[name] = {"out": out, "summary": json.loads(proc.stdout.strip().splitlines()[-1])}

        for n in (1, 2):  # (a) the smoke's subprocess
            child(f"a{n} CLI subprocess -v", lambda out: [
                sys.executable, "-m", "monocular_slam_tpu_torch.run", *cs.cli_args(root, out),
                "--verbose"])
        for v in ("", " -v"):  # (b) fresh children, recorded
            child(f"b fresh child{v}", lambda out, v=v: [
                sys.executable, str(cs.ROOT / "chip_profile.py"), "cliproc-child", root, out,
                *(["--verbose"] if v else [])])

        def here(name, verbose=False):
            out = os.path.join(work, name)
            runs[name] = {"out": out, "summary": recorded_cli(root, out, verbose)}

        here("c0 in process, first")  # (c) in this process
        key3, _, _ = cs.run_key3_course()
        here("c1 after key-3")
        frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
        cs.run_loop(frames, real, poses_gt, k, vocabulary.load_default(), "bundled")
        del frames
        here("c2 after key-3, loop")
        imgs, s_gt, s_k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH,
                                                 device="cuda")
        cs.run_session(imgs, s_gt, s_k, count_syncs=False)
        del imgs
        here("c3 after key-3, loop, session")
        here("c4 again, -v", verbose=True)
        for name, r in runs.items():
            s = r["summary"]
            print(json.dumps({"run": name, "tracked": s["tracked"], "ate_rmse": s["ate_rmse"],
                              "closures": s.get("loop_closures")}), flush=True)
        trajs = {n: open(os.path.join(r["out"], "trajectory.txt"), "rb").read()
                 for n, r in runs.items()}
        for a, b in itertools.combinations(runs, 2):
            row = {"pair": [a, b], "trajectory_equal": trajs[a] == trajs[b]}
            if all(os.path.exists(os.path.join(runs[x]["out"], "records.npz")) for x in (a, b)):
                row |= _first_difference(runs[a]["out"], runs[b]["out"])
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"device": smi}), flush=True)
    return 0


def cli_bisect(smi: str, which: str = "linalg") -> int:
    """`cliproc bisect [k3]`: the cli course in a fresh process, then in
    this process after each step of `k3ab generator`'s first two routes in
    turn (with `k3`: its K3 routes op by op, unchecked then checked against
    `torch.linalg`, after a fresh op-by-op run in a child), each time
    recorded and compared with the fresh run (the first step after which
    they differ is the one that leaves state behind)."""
    import shutil
    import tempfile

    import chip_smoke as cs
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import small_eigh
    from monocular_slam_tpu_torch.retrieval import vocabulary

    cs.loop_noise = generator_noise
    work = tempfile.mkdtemp(prefix="chip_profile_clibisect_")
    try:
        course = cs.cli_course(work)
        root = course["root"]
        fresh = os.path.join(work, "fresh")
        proc = subprocess.run([sys.executable, str(cs.ROOT / "chip_profile.py"), "cliproc-child",
                               root, fresh], capture_output=True, text=True, cwd=str(cs.ROOT),
                              timeout=cs.CLI_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"fresh cli child: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        traj = open(os.path.join(fresh, "trajectory.txt"), "rb").read()
        frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
        imgs, s_gt, s_k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH,
                                                 device="cuda")
        voc = vocabulary.load_default()
        linalg = dict(eigh=small_eigh.eigh_plain, svd3=small_eigh.svd3_plain)

        def route(fns, what):
            def step():
                with k3_sites(**fns), op_by_op_sessions():
                    if what == "key3":
                        cs.run_key3_course(eager=True)
                    elif what == "loop":
                        cs.run_loop(frames, real, poses_gt, k, voc, "bundled", eager=True)
                    elif what == "session":
                        cs.run_session(imgs, s_gt, s_k, count_syncs=False, eager=True)
                    else:
                        cs._run_main_inprocess(cs.cli_args(root, os.path.join(work, "opcli")))
            return step

        def checked(kernel, plain):
            def fn(x):
                out = kernel(x)
                if x.numel():
                    plain(x)
                return out
            return fn

        k3_checked = dict(eigh=checked(small_eigh.eigh, small_eigh.eigh_plain),
                          svd3=checked(small_eigh.svd3, small_eigh.svd3_plain))
        if which == "k3":
            eager = os.path.join(work, "fresh_eager")
            proc = subprocess.run([sys.executable, str(cs.ROOT / "chip_profile.py"),
                                   "cliproc-child", root, eager, "--eager"], capture_output=True,
                                  text=True, cwd=str(cs.ROOT), timeout=cs.CLI_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"eager cli child: exit {proc.returncode}\n"
                                     f"{proc.stderr[-3000:]}")
            print(json.dumps({"fresh process, op by op": json.loads(
                proc.stdout.strip().splitlines()[-1]), "trajectory_equal_fresh": open(
                    os.path.join(eager, "trajectory.txt"), "rb").read() == traj,
                **_first_difference(eager, fresh)}), flush=True)
            steps = [(f"K3 op by op: {w}", route({}, w)) for w in ("key3", "loop", "session")]
            steps += [(f"K3 checked against torch.linalg, op by op: {w}", route(k3_checked, w))
                      for w in ("key3", "loop", "session", "cli")]
        else:
            steps = [("nothing", lambda: None)]
            steps += [(f"torch.linalg route, op by op: {w}", route(linalg, w))
                      for w in ("key3", "loop", "session", "cli")]
            steps += [(f"the parent's calls, op by op: {w}", route(parent_calls(), w))
                      for w in ("key3", "loop", "session", "cli")]
        for n, (name, step) in enumerate(steps):
            step()
            out = os.path.join(work, f"after{n}")
            summary = recorded_cli(root, out, False)
            print(json.dumps({"after": name, "ate_rmse": summary["ate_rmse"],
                              "closures": summary.get("loop_closures"),
                              "trajectory_equal_fresh": open(os.path.join(
                                  out, "trajectory.txt"), "rb").read() == traj,
                              **_first_difference(out, fresh)}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"device": smi}), flush=True)
    return 0


def drivers_full(smi: str) -> int:
    """`drivers`: the ported drivers at their reference's sizes, each JSON
    printed and written to chiprun_out/<driver>_cuda.json: compile_profile
    first, in a fresh build directory before anything has loaded a kernel
    (a true cold start), then step_profile, loop_match_scale (all four
    sections), scaling at 1, 2 and 4 ranks, multihost over 2 processes and
    train_vocab at its defaults."""
    from monocular_slam_tpu_torch.benchmarks import (compile_profile, loop_match_scale,
                                                     multihost, scaling, step_profile,
                                                     train_vocab)

    os.makedirs("chiprun_out", exist_ok=True)

    def emit(name, fn):
        t0 = time.perf_counter()
        out = fn()
        with open(os.path.join("chiprun_out", f"{name}_cuda.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({name: out, "s": time.perf_counter() - t0}), flush=True)

    emit("compile_profile", lambda: compile_profile.run("cuda"))
    emit("step_profile", lambda: step_profile.run("cuda"))
    emit("loop_match_scale", lambda: loop_match_scale.run(device="cuda"))
    emit("scaling", lambda: scaling.run(shards=(1, 2, 4), device="cuda"))
    emit("multihost", lambda: multihost.run(2, device="cuda"))
    emit("vocab_eval", lambda: train_vocab.run(device="cuda"))
    print(json.dumps({"device": smi}), flush=True)
    return 0


TRACED = (("monocular_slam_tpu_torch.slam.loop_closer", "LoopCloser._sim3_device"),
          ("monocular_slam_tpu_torch.geometry.alignment", "ransac_sim3_reproj"),
          ("monocular_slam_tpu_torch.geometry.alignment", "_sample_indices"),
          ("monocular_slam_tpu_torch.geometry.alignment", "horn_sim3"),
          ("monocular_slam_tpu_torch.ops.small_eigh", "svd3"),
          ("monocular_slam_tpu_torch.geometry.alignment", "det3x3"),
          ("monocular_slam_tpu_torch.geometry.alignment", "_dual_reproj_err"),
          ("monocular_slam_tpu_torch.utils.autodiff", "jacfwd"),
          ("torch.linalg", "solve_ex"),
          ("monocular_slam_tpu_torch.slam.loop_closer", "LoopCloser._correct_graph"),
          ("monocular_slam_tpu_torch.optim.pose_graph", "optimize"),
          ("monocular_slam_tpu_torch.slam.loop_closer", "LoopCloser._correct_finish"),
          ("monocular_slam_tpu_torch.slam.loop_closer", "LoopCloser._gba_problem"),
          ("monocular_slam_tpu_torch.optim.ba", "bundle_adjust"),
          ("monocular_slam_tpu_torch.slam.loop_closer", "LoopCloser._gba_finish"))


def _tree_hash(x) -> list:
    """Bit hashes of the tensors and arrays of a nest (ints kept)."""
    from monocular_slam_tpu_torch.utils import graph

    if isinstance(x, np.ndarray):
        return [hash(x.tobytes())]
    if isinstance(x, (bool, int)):
        return [int(x)]
    if isinstance(x, float):
        return [repr(x)]
    if isinstance(x, dict):
        return [h for v in x.values() for h in _tree_hash(v)]
    if isinstance(x, (tuple, list)):
        return [h for v in x for h in _tree_hash(v)]
    return [int(_bit_hash(t)) for t in graph.leaves(x)]


@contextlib.contextmanager
def traced_calls(rows: list):
    """Every call of `TRACED` (op by op only: a replay runs no Python)
    appended to `rows` as (name, input hashes, output hashes)."""
    import importlib

    undo = []
    for mod, attr in TRACED:
        owner = importlib.import_module(mod)
        if "." in attr:
            cls, attr = attr.split(".")
            owner = getattr(owner, cls)
        orig = getattr(owner, attr)

        def wrapped(*a, _orig=orig, _name=attr, **kw):
            args = [v for v in a if not hasattr(v, "voc")] + list(kw.values())
            h_in = _tree_hash(args)
            out = _orig(*a, **kw)
            rows.append((_name, h_in, _tree_hash(out)))
            return out

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))
    try:
        yield rows
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


def traced_cli(root: str, out: str) -> dict:
    """The cli course op by op under `traced_calls`; writes OUT/trace.json."""
    import chip_smoke as cs

    rows: list = []
    with traced_calls(rows), op_by_op_sessions():
        summary, _ = cs._run_main_inprocess(cs.cli_args(root, out))
    with open(os.path.join(out, "trace.json"), "w") as f:
        json.dump(rows, f)
    return summary


def _first_trace_difference(a: str, b: str) -> dict:
    ra = json.load(open(os.path.join(a, "trace.json")))
    rb = json.load(open(os.path.join(b, "trace.json")))
    out = []
    for n, (x, y) in enumerate(zip(ra, rb)):
        if x != y:
            out.append({"call": n, "name": [x[0], y[0]], "inputs_equal": x[1] == y[1],
                        "outputs_equal": x[2] == y[2],
                        "input_fields_differing": [k for k, (p, q) in enumerate(zip(x[1], y[1]))
                                                   if p != q][:20],
                        "output_fields_differing": [k for k, (p, q) in enumerate(zip(x[2], y[2]))
                                                    if p != q][:20]})
            if len(out) == 12:
                break
    return {"calls": [len(ra), len(rb)], "first_differences": out,
            "names_before": [r[0] for r in ra[max(0, out[0]["call"] - 8):out[0]["call"]]]
            if out else []}


def cli_trace(smi: str) -> int:
    """`cliproc trace`: `k3ab generator`'s routes 1-3 (their courses op by
    op), then the cli course op by op on K3 with the loop closer's stages
    traced (`traced_calls`), against the same traced run in a fresh
    process: the first stage call whose inputs or outputs differ."""
    import shutil
    import tempfile

    import chip_smoke as cs
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import small_eigh
    from monocular_slam_tpu_torch.retrieval import vocabulary

    cs.loop_noise = generator_noise
    work = tempfile.mkdtemp(prefix="chip_profile_clitrace_")
    try:
        course = cs.cli_course(work)
        root = course["root"]
        fresh = os.path.join(work, "fresh")
        proc = subprocess.run([sys.executable, str(cs.ROOT / "chip_profile.py"), "cliproc-child",
                               root, fresh, "--trace"], capture_output=True, text=True,
                              cwd=str(cs.ROOT), timeout=cs.CLI_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"fresh cli child: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        print(json.dumps({"fresh, op by op, traced": json.loads(
            proc.stdout.strip().splitlines()[-1])}), flush=True)
        frames, real, poses_gt, k = cs._loop_frames(torch.device("cuda"))
        imgs, s_gt, s_k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH,
                                                 device="cuda")
        voc = vocabulary.load_default()

        def checked(kernel, plain):
            def fn(x):
                out = kernel(x)
                if x.numel():
                    plain(x)
                return out
            return fn

        routes = [parent_calls(), dict(eigh=small_eigh.eigh_plain, svd3=small_eigh.svd3_plain),
                  dict(eigh=checked(small_eigh.eigh, small_eigh.eigh_plain),
                       svd3=checked(small_eigh.svd3, small_eigh.svd3_plain))]
        for n, fns in enumerate(routes):
            with k3_sites(**fns), op_by_op_sessions():
                cs.run_key3_course(eager=True)
                cs.run_loop(frames, real, poses_gt, k, voc, "bundled", eager=True)
                cs.run_session(imgs, s_gt, s_k, count_syncs=False, eager=True)
                if n < 2:
                    cs._run_main_inprocess(cs.cli_args(root, os.path.join(work, f"r{n}")))
        with k3_sites(**routes[2]):
            here = os.path.join(work, "after")
            summary = traced_cli(root, here)
        traj = open(os.path.join(fresh, "trajectory.txt"), "rb").read()
        print(json.dumps({"after routes 1-3, op by op, traced": summary,
                          "trajectory_equal_fresh": open(os.path.join(
                              here, "trajectory.txt"), "rb").read() == traj,
                          **_first_trace_difference(here, fresh)}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"device": smi}), flush=True)
    return 0


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
    if sys.argv[1:2] == ["cliproc-child"]:
        return cliproc_child(sys.argv[2:])
    if sys.argv[1:2] == ["capturegc-child"]:
        return capturegc_child(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[1:2] == ["detsum"]:  # before any import of the package
        return det_sum(smi, sys.argv[2] if len(sys.argv) > 2 else None)
    if sys.argv[1:2] == ["fps"]:
        return fps_run(smi, sys.argv[2] if len(sys.argv) > 2 else None)
    if sys.argv[1:2] == ["k3"]:
        return k3_run(smi, sys.argv[2] if len(sys.argv) > 2 else None)
    if sys.argv[1:2] == ["k3parent"]:
        return k3_parent(smi, sys.argv[2] if len(sys.argv) > 2 else None)
    if sys.argv[1:] == ["drivers"]:  # before anything loads a kernel
        return drivers_full(smi)
    if sys.argv[1:] == ["capturegc"]:
        return capture_gc(smi)
    import chip_smoke as cs
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.utils import prng
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    if sys.argv[1:] == ["window"]:
        return window_ab(smi)
    if sys.argv[1:] == ["cgsteps"]:
        return cg_steps(smi)
    if sys.argv[1:] == ["cgdense"]:
        return cg_dense(smi)
    if sys.argv[1:] == ["cgdense", "long"]:
        return cg_dense_long(smi)
    if sys.argv[1:] == ["nccl"]:
        return nccl_cost(smi)
    if sys.argv[1:2] == ["k3ab"]:
        return k3_ab(smi, generator=sys.argv[2:] == ["generator"])
    if sys.argv[1:] == ["cli"]:
        return cli_run(smi)
    if sys.argv[1:] == ["cliproc"]:
        return cli_proc(smi)
    if sys.argv[1:] == ["cliproc", "trace"]:
        return cli_trace(smi)
    if sys.argv[1:3] == ["cliproc", "bisect"]:
        return cli_bisect(smi, sys.argv[3] if len(sys.argv) > 3 else "linalg")
    if sys.argv[1:2] == ["long"]:
        return long_profile(smi, sys.argv[2] if len(sys.argv) > 2 else None)
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
                lc.compute_sim3(sess.state, i, j, prng.PRNGKey(0))
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
