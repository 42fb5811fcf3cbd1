"""Where the loop-closing session's time goes, on one NVIDIA GPU.

    python3 chip_profile.py          # the loop course, split by stage
    python3 chip_profile.py window   # the tracker's window: dense vs K2
    python3 chip_profile.py long [traj.npz]   # benchmarks/long_run.py's 1000 frames, by stage
    python3 chip_profile.py cli      # the CLI on chip_smoke.py's cli course, by stage
    python3 chip_profile.py cgdense  # CG vs dense global BA on the loop state, by PCG steps
    python3 chip_profile.py cgdense long  # CG vs dense at every CG closure of the 1000-frame long run
    python3 chip_profile.py detsum [ROOT]  # the scale solvers and the session, package from ROOT
    python3 chip_profile.py nccl     # host cost of one all-reduce at NCCL world size 1
    python3 chip_profile.py cgsteps  # chip_smoke.py's long phase at the reference's PCG steps and the port's

`cgdense`: the loop course of `chip_smoke.py`, then global BA on its
perturbed final state through the CG route at 50, 100, 200 and 400 PCG
steps against the dense route (the largest pose difference over the dense
route's largest move, and the scale of a Sim(3) fit of the CG keyframe
centres onto the dense ones), then the scale phase's `correct` comparison
with the CG pose graph at 100, 200, 300 and 400 PCG steps.

`cgdense long`: `chip_smoke.run_long` over the full 1000 frames at the
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

`nccl`: a one-rank NCCL group in this process; 500 calls of
`distributed.all_reduce` on a (1000, 6) float32 tensor, host seconds per
call, on an idle card and queued behind a matmul chain of ~0.2 s (if a call
returns before the chain ends, it does not wait for the card), and
`torch.profiler`'s kernels and host events of 20 calls.

`cgsteps`: `chip_smoke.run_long` (400 frames, switch at 128) twice in
one process, the loop closer's CG routes at the reference's PCG step
counts (50 for global BA, 100 for the pose graph) and at the port's
(`GLOBAL_BA_CG_ITERS`, `POSE_GRAPH_CG_ITERS`): tracked, ATE, closures,
closure stage seconds.

`cli`: `chip_smoke.py`'s cli course (200 frames of the long run's orbit
written as a TUM directory) through `run.main` in this process with every
stage wrapped as below, the PNG decode (`TumSequence.load_image`) too.
Prints the stage rows (shares of the CLI's own main-loop wall time), then
the CLI's summary.

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
            out, sess = cs.run_long(LONG_RUN_FRAMES)
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
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    fast_score.load()
    hamming.load()
    out = {"package": monocular_slam_tpu_torch.__file__}
    g = cs._scale_pose_graph("cuda")
    prob, _ = cs._scale_ba_problem("cuda")
    for name, fn in (("pose_graph_cg_s_per_lm_iter",
                      lambda: pose_graph.optimize_cg(g, n_iters=cs.SCALE_ITERS)),
                     ("global_ba_cg_s_per_lm_iter",
                      lambda: cg_ba.bundle_adjust_cg(prob, n_iters=cs.SCALE_ITERS, max_cg_iters=50))):
        fn()
        times = [cs._timed_solve(fn)[1] / cs.SCALE_ITERS for _ in range(3)]
        out[name] = min(times)
        out[name + "_all"] = times
    imgs, poses_gt, k = render.render_sequence(seed=11, n_frames=cs.N_FRAMES, wh=cs.WH, device="cuda")
    run = cs.run_session(imgs, poses_gt, k, count_syncs=False)
    out |= {"session_fps_10_59": run["fps_10_59"], "session_ate_m": run["ate_m"]}
    print(json.dumps({"device": smi, **out}), flush=True)
    return 0


def cg_steps(smi: str) -> int:
    import chip_smoke as cs
    from monocular_slam_tpu_torch.slam import loop_closer

    port = loop_closer.GLOBAL_BA_CG_ITERS, loop_closer.POSE_GRAPH_CG_ITERS
    try:
        for steps in ((50, 100), port):
            loop_closer.GLOBAL_BA_CG_ITERS, loop_closer.POSE_GRAPH_CG_ITERS = steps
            with cs.reference_pose_graph_switch():
                out, _ = cs.run_long(cs.LONG_FRAMES)
            print(json.dumps({"pcg_steps_global_ba_pose_graph": steps,
                              **{k: out[k] for k in ("tracked", "ate_m", "fps", "closures",
                                                     "corrected", "closure_s_per_run")},
                              "routes": {r: len(c) for r, c in out["routes"].items()}}),
                  flush=True)
    finally:
        loop_closer.GLOBAL_BA_CG_ITERS, loop_closer.POSE_GRAPH_CG_ITERS = port
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[1:2] == ["detsum"]:  # before any import of the package
        return det_sum(smi, sys.argv[2] if len(sys.argv) > 2 else None)
    import chip_smoke as cs
    from monocular_slam_tpu_torch.ops import fast_score, hamming
    from monocular_slam_tpu_torch.retrieval import vocabulary
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
    if sys.argv[1:] == ["cli"]:
        return cli_run(smi)
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
