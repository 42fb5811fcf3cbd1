"""The port's benchmark: one cell, one run.

    python3 -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is a camera at its published rate feeding `monocular_slam_tpu_torch`'s
`SlamSession` in an open loop. Everything that belongs to a cell is data,
found by the names in `BENCHMARK.json`'s `workloads` entry:
`slambench/configs/<config>.json` (the deployment: camera, ORB extractor,
the session's and the loop closer's settings), `slambench/traffic/<traffic>.json`
(rate, warm-up frames, the orbit's angular steps by segment, the scene's
seed, the traced frames), `slambench/limits/<workload>.json` (the limits of
`correct`), and one reader `slambench/layer_metrics/<metric>.py` per
per-layer metric.

Set-up (`setup_s`, from process start to the first due frame): the port's
kernels built into `slambench/_build/` (only a checkout's first run
compiles), the course rendered on the card by the frozen generator (its
textures from the traffic file's `scene_seed`, so every seed of a cell
sees one room) and copied to the host as uint8 frames, the frozen vocabulary loaded, the session (seeded by
`--seed`) and its loop closer built and prewarmed, and the warm-up frames
fed as fast as the session takes them. In the window frame j is due at
t0 + j / rate: the harness sleeps until `SPIN_S` before then and spins to
it (or feeds it at once when the session is behind), calls
`add_frame(frame, k)` and reads the frame's pose to the host; the frame's
latency runs from its due time to the end of that read. With `--trace 1` the same window is run with CUDA
events around every frame and `torch.profiler` over the traffic file's
traced frames, and the per-layer metrics are reported instead.

After the window the program's answers are judged against the plain
reference (`slambench/check.py`); the numbers and their limits are the last
lines on standard error and the `checks` key of the result, the last line
of standard output. The run fails without printing a result when no card
is there, and when `jax`, `jaxlib`, `flax` or the JAX package is loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import check, course, work  # noqa: E402
from slambench import trace as trace_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "monocular_slam_tpu")
SPIN_S = 0.002  # the generator sleeps until this long before a frame is due, then spins


def log(*parts) -> None:
    print("[slambench]", *parts, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    `FORBIDDEN`, compared whole: `monocular_slam_tpu_torch` is not
    `monocular_slam_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entry of `root/BENCHMARK.json` with its configuration,
    traffic, limits and per-layer metrics, found by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    bench = root / "slambench"
    layer = [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]
    ends = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    return {
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((bench / "limits" / f"{workload}.json").read_text()),
        "per_layer": layer,
        "end_to_end": ends,
        "bench": bench,
    }


def reader(bench: Path, name: str):
    """The `read(run)` function of `bench/layer_metrics/<name>.py`."""
    path = bench / "layer_metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def slam_config(conf: dict, max_frames: int):
    """The port's `SlamConfig` and `LoopClosureConfig` of a configuration
    file, holding `max_frames` frames."""
    from monocular_slam_tpu_torch.slam import config as C
    from monocular_slam_tpu_torch.slam.loop_closer import LoopClosureConfig

    groups = {"frontend": C.FrontendConfig, "init": C.InitConfig, "track": C.TrackConfig,
              "ba": C.BAConfig, "mapping": C.MappingConfig}
    kw = {}
    for key, val in conf["slam"].items():
        kw[key] = groups[key](**val) if key in groups else tuple(val) if key == "image_wh" else val
    return C.SlamConfig(max_frames=max_frames, **kw), LoopClosureConfig(**conf["loop_closer"])


def collect_answers(state, first: int, n: int, poses, tracked, rng, n_check: int) -> dict:
    """The program's answers that `check.numbers` judges: the window's poses
    as read and tracked flags, the stored features of `n_check` resident
    window frames drawn with `rng`, and every map-point observation of the
    resident window frames with their final poses (host copies)."""
    host = {f: getattr(state, f).cpu().numpy() for f in (
        "poses", "pose_valid", "k", "kp_uv", "kp_scale", "kp_valid", "desc", "feat_point",
        "slot_of", "frame_of", "points", "point_valid")}
    frames = np.arange(first, first + n)
    slot = host["slot_of"][frames]
    resident = (slot >= 0) & (host["frame_of"][np.maximum(slot, 0)] == frames)
    res_idx = np.flatnonzero(resident)
    pick = np.sort(rng.choice(res_idx, size=min(n_check, len(res_idx)), replace=False))
    feats = {}
    for j in pick.tolist():
        s = slot[j]
        feats[j] = {"uv": host["kp_uv"][s], "scale": host["kp_scale"][s],
                    "desc": host["desc"][s], "valid": host["kp_valid"][s]}
    obs = {k: [] for k in ("pose", "k", "uv", "scale", "pid")}
    for j in res_idx.tolist():
        f, s = frames[j], slot[j]
        if not host["pose_valid"][f]:
            continue
        pid = host["feat_point"][s]
        m = host["kp_valid"][s] & (pid >= 0)
        m[m] = host["point_valid"][pid[m]]
        cnt = int(m.sum())
        obs["pose"].append(np.repeat(host["poses"][f][None], cnt, 0))
        obs["k"].append(np.repeat(host["k"][f][None], cnt, 0))
        obs["uv"].append(host["kp_uv"][s][m])
        obs["scale"].append(host["kp_scale"][s][m])
        obs["pid"].append(pid[m].astype(np.int64))
    obs = {k: (np.concatenate(v) if v else np.zeros((0,))) for k, v in obs.items()}
    return {"poses": poses, "tracked": tracked, "features": feats, "obs": obs,
            "points": host["points"], "n_resident": len(res_idx)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, control: bool = False, t_start: float | None = None) -> dict:
    """One run of `workload`: its result line's object, and with `control`
    also the control's readings under `"control"`."""
    import torch

    t_start = _T_START if t_start is None else t_start
    spec = load_cell(root, workload)
    conf, traffic = spec["config"], spec["traffic"]
    rate = float(traffic["rate_hz"])
    n_warm = int(traffic["warmup_frames"])
    n_win = int(round(rate * seconds))
    split = {}

    from monocular_slam_tpu_torch.ops import fast_score, hamming, small_eigh
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils import cuda_build
    split["import_s"] = time.perf_counter() - t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    t = time.perf_counter()
    if cuda:
        cuda_build.use_build_dir(spec["bench"] / "_build")
        for mod in (fast_score, hamming, small_eigh):
            mod.load()
    split["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cam = conf["camera"]
    k = np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], np.float32)
    wh = tuple(conf["slam"]["image_wh"])
    frames, gt = course.render(int(traffic["scene_seed"]), n_warm + n_win,
                               traffic["segments"], wh, k, dev,
                               int(traffic.get("texture_size", 2048)))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    split["render_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg, lcfg = slam_config(conf, n_warm + n_win + 1)
    voc = vocabulary.load(str(spec["bench"] / "data" / "default_vocab.npz"), dev)
    lc = LoopCloser(voc, cfg, lcfg, device=dev)
    sess = SlamSession(cfg, seed=seed, run_ba=True, loop_closer=lc, device=dev)
    split["session_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sess.prewarm(image=True)
    split["prewarm_s"] = time.perf_counter() - t

    t = time.perf_counter()
    for f in range(n_warm):
        st = sess.add_frame(frames[f], k, timestamp=f / rate)
        sess.state.poses[st.frame].cpu()
    if cuda:
        torch.cuda.synchronize()
    split["warmup_s"] = time.perf_counter() - t
    calls0 = len(sess.program_calls)
    closures0 = len(lc.closures)
    captured0 = set(sess.capture_s)

    prof, span = None, contextlib.nullcontext
    n_traced = min(int(traffic["trace_frames"]), n_win)
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        first = n_win - n_traced
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts, schedule=schedule(
            wait=max(first - 3, 0), warmup=min(first, 3), active=n_traced, repeat=1))
        prof.start()
        span = functools.partial(record_function, trace_mod.FRAME_SPAN)
    records, stats, oversleep = [], [], []
    poses = np.zeros((n_win, 3, 4), np.float32)
    lat = np.zeros(n_win)
    t0 = time.perf_counter() + 0.02
    setup_s = t0 - t_start
    for j in range(n_win):
        due = t0 + j / rate
        now = time.perf_counter()
        if now < due:
            if now < due - SPIN_S:
                time.sleep(due - SPIN_S - now)
            while time.perf_counter() < due:
                pass
            oversleep.append(time.perf_counter() - due)
        runs0, reloc0, caps0 = lc.timings["n_runs"], sess.reloc_attempts, len(sess.capture_s)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if trace and cuda else None
        with span():
            if ev:
                ev[0].record()
            st = sess.add_frame(frames[n_warm + j], k, timestamp=j / rate)
            if ev:
                ev[1].record()
            poses[j] = sess.state.poses[st.frame].cpu().numpy()
        lat[j] = time.perf_counter() - due
        if prof is not None:
            prof.step()
        stats.append(st)
        records.append({"j": j, "frame": st.frame, "events": ev,
                        "other_work": lc.timings["n_runs"] > runs0 or sess.reloc_attempts > reloc0,
                        "captures": len(sess.capture_s) - caps0})
    window_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    backlog_s = float(lat[-1])
    sess.flush()
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    tracked = np.array([bool(s.tracked) for s in stats])
    for r, s in zip(records, stats):
        launches = s.launches or {}
        ev = r.pop("events")
        r.update(is_keyframe=bool(s.is_keyframe), tracked=bool(s.tracked),
                 k1=launches.get("corner_maps"), k2=launches.get("hamming_top2"),
                 span_ms=ev[0].elapsed_time(ev[1]) if ev else None)
    calls = sess.program_calls[calls0:]
    closures = list(lc.closures[closures0:])

    tr = trace_mod.reduce(prof.profiler.kineto_results.events()) if prof is not None else None
    del prof

    rng = np.random.default_rng(seed)
    ans = collect_answers(sess.state, n_warm, n_win, poses, tracked, rng,
                          int(traffic.get("check_frames", 8)))
    fe = {key: getattr(cfg.frontend, key)
          for key in ("n_features", "n_levels", "fast_threshold", "steer_mode")}
    slow = np.argsort(-lat)[:6]
    info = {
        "slow_frames": [[int(j), round(1e3 * lat[j], 3), records[j]["is_keyframe"],
                         records[j]["other_work"], records[j]["captures"]] for j in slow],
        "captured_in_window": sorted(str(key[:2]) for key in set(sess.capture_s) - captured0),
        "capture_frames": [r["j"] for r in records if r["captures"]],
        "keyframes": len(sess.keyframes), "tracked": int(tracked.sum()),
        "closures": [list(c) for c in closures],
        "corrected": [list(c) for c in lc.corrected if c in closures],
        "ate_cm": check.geometry.ate_cm(poses, gt[n_warm:], tracked),
        "n_resident": ans["n_resident"], "capture_s_total": float(sum(sess.capture_s.values())),
    }
    del sess, lc, voc, st, stats
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    images = {j: frames[n_warm + j] for j in ans["features"]}
    values = check.numbers(ans, gt[n_warm:], images, fe, dev)
    ok, checks = check.judge(values, spec["limits"])
    out = {"correct": bool(ok), "attempted": n_win, "failed": int(n_win - tracked.sum())}
    if control:
        out["control"] = check.numbers(ans, gt[n_warm:], images, fe, dev, control=True)
        out["readings"] = values

    log("set-up split (s):", json.dumps({k: round(v, 3) for k, v in split.items()}))
    log("generator:", json.dumps({
        "rate_hz": rate, "frames": n_win, "window_s": window_s,
        "slept": len(oversleep), "oversleep_ms_max": 1e3 * max(oversleep, default=0.0),
        "oversleep_ms_mean": 1e3 * float(np.mean(oversleep)) if oversleep else 0.0,
        "last_frame_latency_s": backlog_s,
        "mean_ms_by_5s": [round(1e3 * float(np.mean(b)), 3)
                          for b in np.array_split(lat, max(1, round(n_win / (5 * rate))))]}))
    log("outcome:", json.dumps(info))
    log("readings:", json.dumps(values))
    return _finish(out, spec, records, calls, closures, tr, lat, setup_s, trace, dev, mem_peak,
                   conf, traffic, checks)


def _finish(out, spec, records, calls, closures, tr, lat, setup_s, trace, dev, mem_peak,
            conf, traffic, checks) -> dict:
    """The result's object: end-to-end metrics (or, traced, the per-layer
    readers' values, `busy_s`, `window_s` and the breakdown), the device,
    and the checks last."""
    import torch

    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
              "memory_peak_bytes": mem_peak}
    metrics = {}
    extra = {}
    if trace:
        run = SimpleNamespace(frames=records, calls=calls, closures=closures, trace=tr,
                              traced=records[len(records) - len(tr.frames):] if tr else [],
                              config=conf, traffic=traffic, device_name=name, work=work)
        for m in spec["per_layer"]:
            val = reader(spec["bench"], m["name"])(run)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        if tr is not None and len(tr.frames):
            lo, hi = trace_mod.window(tr)
            device["busy_s"] = trace_mod.busy_ns(tr, lo, hi) * 1e-9
            device["window_s"] = (hi - lo) * 1e-9
            extra["breakdown"] = trace_mod.breakdown(tr)
    else:
        ends = {"frame_ms_mean": 1e3 * float(np.mean(lat)),
                "frame_ms_p95": 1e3 * float(np.percentile(lat, 95)), "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": ends[m["name"]], "unit": m["unit"]}
    res = dict(out)
    aside = {k: res.pop(k) for k in ("control", "readings") if k in res}
    res.update(metrics=metrics, device=device, **extra, **aside)
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    chips = int(load_cell(ROOT, a.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        log("loaded modules the benchmark must not load:", ", ".join(bad))
        return 3
    for key, c in res["checks"].items():
        log(f"check {key}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
