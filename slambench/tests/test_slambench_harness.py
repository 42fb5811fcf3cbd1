"""The harness on the CPU at a tiny size: a cell added as data only (a
configuration, a traffic mix, a limits file and a per-layer reader, in a
scratch copy of the benchmark) runs through `run_cell` with the session's
plain paths; the result line has the contract's keys; no JAX module is
loaded; a configuration's lens reaches every `add_frame` call, and a
pinhole's none; a configuration's own check (`slambench/checks/`) is
collected from the live session and judged for the program and the
control, and the existing cells' numbers are unchanged by the hook; a
kidnapped camera is relocalized and its pose judged; and `correct` comes
out false when the timed path is broken."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slambench import check, control, course, run, trace
from slambench.layer_metrics import _frames, frame_idle_pct, reloc_ms

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL = "tiny_vga.tiny10"
LENS_CELL = "tiny_mav.tiny10"  # EuRoC's camera at half its size, lens as published
PROBE_CELL = "tiny_probe.tiny10"  # tiny_vga naming a check of its own
KIDNAP_CELL = "tiny_tum2.kidnap10"  # TUM2's camera at half its size, kidnapped once
# ORB-SLAM2's TUM2.yaml: TUM RGB-D's Freiburg 2 camera, 640x480, and its radtan lens
TUM2 = {"fx": 520.908620, "fy": 521.007327, "cx": 325.141442, "cy": 249.701764,
        "k1": 0.231222, "k2": -0.784899, "p1": -0.003257, "p2": -0.000105, "k3": 0.917205}
WARMUP = 15
LIMITS = {"kp_mismatch_pct": 1.0, "rpe_rot_mrad_p50": 3.0, "rot_over_2.5mrad_pct": 60.0}
KIDNAP_LIMITS = dict(LIMITS, reloc_map_mrad_p50=3.0)
# sweeps of 20 frames at 0.06 rad (1.2 rad, past the half-size lens's 1.08 rad field),
# each followed by a jump back to its start; the warm-up holds one kidnap and the
# 3 s window starts 8 frames into a sweep and holds the next
KIDNAP_SWEEP, KIDNAP_STEP, KIDNAP_WARMUP, KIDNAP_SECONDS = 20, 0.06, 29, 3.0
READER = '''
def read(run):
    return float(len(run.frames)) if run.frames else None
'''
PROBE = '''
import numpy as np
from slambench import check


def collect(sess, lc, first, n):
    return {"frames": len(sess.stats), "first": first, "n": n,
            "closer": lc is sess.loop_closer}


def numbers(ans, gt, collected, traffic, control):
    rounded = np.array_equal(check.bf16(ans["poses"]), ans["poses"])
    return {"probe_frames": float(collected["frames"]), "probe_rounded": float(rounded),
            "probe_closer": float(collected["closer"]), "probe_rate": traffic["rate_hz"]}
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A scratch copy of the benchmark with one more cell, added as files
    and entries only."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", dst)
    shutil.copytree(REPO / "slambench", dst / "slambench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "tests"))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_vga", "source": "https://example.org/tiny",
                            "file": "slambench/configs/tiny_vga.json", "reduced": [],
                            "why": "the CPU test's size"})
    spec["configs"].append({"name": "tiny_mav", "source": "https://example.org/tiny",
                            "file": "slambench/configs/tiny_mav.json", "reduced": [],
                            "why": "the CPU test's size, with a lens"})
    spec["workloads"].append({"name": CELL, "config": "tiny_vga", "traffic": "tiny10",
                              "chips": 1, "why": "the CPU test's cell"})
    spec["workloads"].append({"name": LENS_CELL, "config": "tiny_mav", "traffic": "tiny10",
                              "chips": 1, "why": "the CPU test's cell behind a lens"})
    spec["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "tracking",
                              "moves": "frame_ms_mean", "workloads": [CELL]})
    for name, traffic in (("tiny_probe", "tiny10"), ("tiny_tum2", "kidnap10")):
        spec["configs"].append({"name": name, "source": "https://example.org/tiny",
                                "file": f"slambench/configs/{name}.json", "reduced": [],
                                "why": "the CPU test's size"})
        spec["workloads"].append({"name": f"{name}.{traffic}", "config": name,
                                  "traffic": traffic, "chips": 1, "why": "the CPU test's cell"})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    conf = json.loads((REPO / "slambench/configs/tum1_vga.json").read_text())
    conf["slam"].update(image_wh=[320, 240], max_points=4000, max_slots=None)
    conf["slam"]["frontend"]["n_features"] = 500
    conf["camera"].update(fx=258.653, fy=258.235, cx=159.32, cy=127.66)
    (dst / "slambench/configs/tiny_vga.json").write_text(json.dumps(conf))
    (dst / "slambench/configs/tiny_probe.json").write_text(json.dumps(dict(conf, checks=["probe"])))
    # ORB-SLAM2's tracking gates (30 inliers tracked, 50 relocalized) and the
    # closer bypassed: the sweeps revisit the last one's views
    conf = dict(json.loads(json.dumps(conf)), checks=["reloc"], camera=_half(TUM2),
                loop_closer={"min_gap": 1000, "cooldown": 60})
    conf["slam"]["track"] = {"back_traverse": 5, "pnp_min_inliers": 30, "reloc_min_inliers": 50}
    (dst / "slambench/configs/tiny_tum2.json").write_text(json.dumps(conf))
    conf = json.loads((REPO / "slambench/configs/euroc_mav.json").read_text())
    conf["slam"].update(image_wh=[376, 240], max_points=4000, max_slots=None)
    conf["slam"]["frontend"]["n_features"] = 500
    conf["camera"].update(fx=229.327, fy=228.648, cx=183.6075, cy=124.1875)
    (dst / "slambench/configs/tiny_mav.json").write_text(json.dumps(conf))
    (dst / "slambench/traffic/tiny10.json").write_text(json.dumps({
        "rate_hz": 10.0, "warmup_frames": WARMUP, "segments": [[0, 0.01]], "scene_seed": 7,
        "trace_frames": 3, "check_frames": 2, "texture_size": 256}))
    (dst / "slambench/traffic/kidnap10.json").write_text(json.dumps({
        "rate_hz": 10.0, "warmup_frames": KIDNAP_WARMUP,
        "segments": [[KIDNAP_SWEEP, KIDNAP_STEP], [1, -KIDNAP_SWEEP * KIDNAP_STEP]] * 3,
        "scene_seed": 7, "trace_frames": 3, "check_frames": 2, "texture_size": 256}))
    for cell in (CELL, LENS_CELL):
        (dst / f"slambench/limits/{cell}.json").write_text(json.dumps(LIMITS))
    (dst / f"slambench/limits/{PROBE_CELL}.json").write_text(json.dumps(dict(
        LIMITS, probe_rounded=0.5, probe_closer=1.0)))
    (dst / f"slambench/limits/{KIDNAP_CELL}.json").write_text(json.dumps(KIDNAP_LIMITS))
    (dst / "slambench/layer_metrics/frames_seen.py").write_text(READER)
    (dst / "slambench/checks/probe.py").write_text(PROBE)
    return dst


def _half(cam: dict) -> dict:
    """A camera at half its size: the same lens, half the focal lengths and
    principal point."""
    return dict(cam, **{key: cam[key] / 2 for key in ("fx", "fy", "cx", "cy")})


def _run(root, trace=False, seed=7, cell=CELL):
    torch.set_num_threads(2)
    seconds = KIDNAP_SECONDS if cell == KIDNAP_CELL else 1.0
    return run.run_cell(cell, seed, seconds, trace, device="cpu", root=root)


def test_benchmark_names_and_units():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [r for c in spec["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in spec["end_to_end"] + spec["per_layer"])
    for w in spec["workloads"]:
        assert (REPO / f"slambench/traffic/{w['traffic']}.json").exists()
        assert (REPO / f"slambench/limits/{w['name']}.json").exists()
    for m in spec["per_layer"]:
        assert (REPO / f"slambench/layer_metrics/{m['name']}.py").exists()
    for c in spec["configs"]:
        for name in json.loads((REPO / c["file"]).read_text()).get("checks", []):
            assert (REPO / f"slambench/checks/{name}.py").exists()


def test_a_cell_added_as_data_runs(root):
    res = _run(root, trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["metrics"]["frames_seen"] == {"value": 10.0, "unit": "frames"}
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 10 and res["failed"] == 0
    res = _run(root)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"frame_ms_mean", "frame_ms_p95", "setup_s"}
    assert set(res["checks"]) == set(LIMITS)
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("cell", [CELL, LENS_CELL])
def test_the_lens_reaches_every_add_frame(root, monkeypatch, cell):
    """A pinhole's frames are fed with no `dist`; a lens's with its five
    published coefficients in float32 on every call, warm-up and window,
    and its keypoints then match the reference's undistorted ones."""
    from monocular_slam_tpu_torch.slam import session

    seen, orig = [], session.SlamSession.add_frame

    def add_frame(self, img, k, *a, **kw):
        seen.append(kw.get("dist", "none"))
        return orig(self, img, k, *a, **kw)

    monkeypatch.setattr(session.SlamSession, "add_frame", add_frame)
    res = _run(root, cell=cell)
    assert len(seen) == WARMUP + 10
    if cell == CELL:
        assert all(d == "none" for d in seen)
    else:
        conf = json.loads((root / "slambench/configs/tiny_mav.json").read_text())["camera"]
        want = np.array([conf[c] for c in ("k1", "k2", "p1", "p2", "k3")], np.float32)
        for d in seen:
            assert d.dtype == np.float32
            np.testing.assert_array_equal(d, want)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["kp_mismatch_pct"]["value"] < 0.5, res["checks"]


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["monocular_slam_tpu_torch.slam", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["monocular_slam_tpu.ops", "jax.numpy", "numpy"]) == [
        "jax", "monocular_slam_tpu"]


def test_no_result_without_a_card(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "slambench.run", "--workload", "tum1_vga.desk30",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _unchanged(orig):
    def step(state, *a, **kw):
        _, stats = orig(state, *a, **kw)
        return state, stats
    return step


def _half_left_out(orig):
    def extract(*a, **kw):
        f = orig(*a, **kw)
        return f._replace(valid=f.valid & (torch.arange(len(f.valid)) % 2 == 0))
    return extract


def _pose_altered(orig):
    """Every other frame's pose turned by 10 mrad about the vertical and
    moved by 2% of its translation."""
    c, s = np.cos(0.01), np.sin(0.01)
    turn = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float32)

    def step(state, i, *a, **kw):
        new, stats = orig(state, i, *a, **kw)
        if int(i) % 2:
            poses = new.poses.clone()
            poses[int(i)] = turn @ poses[int(i)] * torch.tensor([1.0, 1.0, 1.0, 1.02])
            new = new._replace(poses=poses)
        return new, stats
    return step


def _keyframe_pose_altered(orig):
    """The pose of each window frame that made a keyframe turned by 30 mrad
    about the vertical, and no other frame's."""
    c, s = np.cos(0.03), np.sin(0.03)
    turn = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float32)

    def step(state, i, *a, **kw):
        new, stats = orig(state, i, *a, **kw)
        if int(i) >= WARMUP and bool(stats.is_keyframe):
            poses = new.poses.clone()
            poses[int(i)] = turn @ poses[int(i)]
            new = new._replace(poses=poses)
        return new, stats
    return step


def _lens_withheld(orig):
    def add_frame(self, img, k, timestamp=0.0, dist=None):
        return orig(self, img, k, timestamp)
    return add_frame


def _relocalized_pose_turned(orig):
    """The pose the host read at each recovery, and at the frames tracked
    from it up to `reloc.FOLLOW` later, turned by 5 mrad about the vertical
    before they are judged: a relocalization that lands off and that
    tracking follows."""
    from slambench.checks import reloc

    c, s = np.cos(0.005), np.sin(0.005)
    turn = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)

    def collect_answers(state, first, n, poses, tracked, *a):
        poses = poses.copy()
        for r in check.recoveries(tracked):
            poses[r:r + reloc.FOLLOW + 1] = turn @ poses[r:r + reloc.FOLLOW + 1]
        return orig(state, first, n, poses, tracked, *a)
    return collect_answers


@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_keypoints", "pose_altered",
                                   "keyframe_pose_altered", "lens_withheld",
                                   "relocalized_pose_turned"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    from monocular_slam_tpu_torch.ops import features
    from monocular_slam_tpu_torch.slam import session

    cell = CELL
    if fault == "relocalized_pose_turned":
        monkeypatch.setattr(run, "collect_answers", _relocalized_pose_turned(run.collect_answers))
        cell = KIDNAP_CELL
    elif fault == "lens_withheld":
        # the session is fed the lens's frames as if through a pinhole
        monkeypatch.setattr(session.SlamSession, "add_frame",
                            _lens_withheld(session.SlamSession.add_frame))
        cell = LENS_CELL
    elif fault == "unchanged_state":
        monkeypatch.setattr(session, "session_step", _unchanged(session.session_step))
    elif fault == "half_the_keypoints":
        monkeypatch.setattr(features, "extract", _half_left_out(features.extract))
    elif fault == "pose_altered":
        monkeypatch.setattr(session, "session_step", _pose_altered(session.session_step))
    else:
        monkeypatch.setattr(session, "session_step", _keyframe_pose_altered(session.session_step))
    res = _run(root, cell=cell)
    assert res["correct"] is False, res["checks"]
    assert np.isfinite(res["metrics"]["frame_ms_mean"]["value"])
    if fault == "keyframe_pose_altered":
        # a fault on a few frames: the tail catches it (here keyframes are a
        # third of the window's frames, so the median does too)
        tail = res["checks"]["rot_over_2.5mrad_pct"]
        assert tail["value"] > tail["limit"], res["checks"]
    if fault == "relocalized_pose_turned":
        reloc = res["checks"]["reloc_map_mrad_p50"]
        assert reloc["value"] > reloc["limit"], res["checks"]


def test_the_kidnap_course_jumps_past_the_field_of_view(root):
    """The one-frame segments jump the orbit back to each sweep's start,
    farther than the half-size TUM2 lens sees across: once in the warm-up,
    whose relocalization lies before the window, and once in the window."""
    traffic = json.loads((root / "slambench/traffic/kidnap10.json").read_text())
    n = KIDNAP_WARMUP + int(KIDNAP_SECONDS * traffic["rate_hz"])
    steps = np.diff(course.orbit_angles(n, traffic["segments"]))
    jumps = np.flatnonzero(np.abs(steps) > 0.5) + 1
    np.testing.assert_array_equal(jumps, [KIDNAP_SWEEP + 1, 2 * KIDNAP_SWEEP + 2])
    np.testing.assert_allclose(np.delete(steps, jumps - 1), KIDNAP_STEP, rtol=1e-9)
    cam = _half(TUM2)
    k = np.array([cam[c] for c in ("fx", "fy", "cx", "cy")])
    rays = course.lens_rays(k, (320, 240), check.camera.coefficients(cam))
    field = np.arctan(rays[120, -1, 0]) - np.arctan(rays[120, 0, 0])
    assert 1.0 < field < np.abs(steps[jumps - 1]).min()
    # the window opens inside a sweep, after the lost frames and the
    # relocalization (`reloc_after` 3, `stat_lag` 3) of the warm-up's kidnap
    assert jumps[0] + 5 < KIDNAP_WARMUP < jumps[1]


def test_a_kidnap_is_relocalized_and_judged(root, capfd):
    """The jump loses track, relocalization gets the pose back inside the
    window, and the relocalized session is judged by its own finite
    number, under its limit; the recovery's own error is read too."""
    res = _run(root, cell=KIDNAP_CELL)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(KIDNAP_LIMITS)
    assert np.isfinite(res["checks"]["reloc_map_mrad_p50"]["value"])
    err = capfd.readouterr().err.splitlines()
    outcome, readings = (json.loads(next(line.split(f"{key}: ", 1)[1] for line in err
                                         if f"{key}: " in line)) for key in ("outcome", "readings"))
    assert np.isfinite(readings["reloc_rot_mrad_p50"])
    assert len(outcome["recoveries"]) == 1 and outcome["reloc_successes"] >= 1
    assert outcome["lost_runs"] and res["failed"] == sum(outcome["lost_runs"])
    assert outcome["closures"] == []


def test_a_configurations_own_check_reaches_judge_and_the_control(root):
    """`collect` reads the live session after its last frame is drained;
    the module's numbers join the program's and the control's, which gets
    its poses rounded to bfloat16, and the limits file judges them."""
    line = control.reading(PROBE_CELL, 7, 1.0, root=root, device="cpu")
    assert line["program"]["probe_frames"] == WARMUP + 10
    assert line["program"]["probe_closer"] == 1.0 and line["program"]["probe_rate"] == 10.0
    assert line["program"]["probe_rounded"] == 0.0 and line["control"]["probe_rounded"] == 1.0
    assert line["correct"] is True
    assert line["control_checks"]["probe_rounded"] == {"value": 1.0, "limit": 0.5}
    assert line["control_correct"] is False


@pytest.mark.parametrize("control_", [False, True], ids=["program", "control"])
@pytest.mark.parametrize("cell", ["tum1_vga.desk30", "kitti_wide.orbit10", "euroc_mav.flight20"])
def test_a_configuration_without_checks_keeps_the_numbers(cell, control_):
    """The existing cells name no checks of their own, and their numbers on
    the same answers are what the harness gave before the hook (recorded
    from it), for the program and the control."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"]
                if c["name"] == next(w for w in spec["workloads"] if w["name"] == cell)["config"])
    names = json.loads((REPO / conf["file"]).read_text()).get("checks", [])
    assert names == []
    args, lens = _synthetic_answers(cell)
    got = check.numbers(*args, control=control_, lens=lens,
                        checks=run.check_modules(REPO / "slambench", names), collected={},
                        traffic={})
    want = BEFORE_THE_HOOK[cell][control_]
    assert list(got) == list(want)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_reloc_ms_reads_the_relocalization_programs_per_recovery():
    frames = [{"tracked": t} for t in (True, False, False, True, True, False, True)]
    calls = [{"kind": "reloc_scores", "ms": 1.5}, {"kind": "relocalize", "ms": 2.0},
             {"kind": "cull", "ms": 9.0}, {"kind": "relocalize", "ms": 2.5}]
    assert reloc_ms.read(SimpleNamespace(frames=frames, calls=calls)) == pytest.approx(3.0)
    assert reloc_ms.read(SimpleNamespace(frames=frames[:2], calls=calls)) is None
    assert reloc_ms.read(SimpleNamespace(frames=frames, calls=calls[2:3])) is None
    assert run.lost_runs([f["tracked"] for f in frames]) == [2, 1]


def test_the_control_is_judged_not_correct(root):
    line = control.reading(CELL, 7, 1.0, root=root, device="cpu")
    assert line["correct"] is True, line["program"]
    assert line["control_correct"] is False, line["control_checks"]
    assert set(line["control_checks"]) == set(LIMITS)
    assert line["control_checks"]["kp_mismatch_pct"]["value"] > LIMITS["kp_mismatch_pct"]


def test_the_control_behind_a_lens_is_judged_not_correct(root):
    """The control's extraction is undistorted as the reference's is, and
    still fails where the program passes."""
    line = control.reading(LENS_CELL, 7, 1.0, root=root, device="cpu")
    assert line["correct"] is True, line["program"]
    assert line["control_correct"] is False, line["control_checks"]
    assert line["control_checks"]["kp_mismatch_pct"]["value"] > LIMITS["kp_mismatch_pct"]


def test_profiler_own_host_work_is_no_idle_time():
    # frame [0, 100): device busy [10, 30), profiler's buffer flush [40, 70)
    # over a device op [60, 65); idle is [0, 10), [30, 40) and [70, 100)
    events = [_Ev("slambench.frame", "CPU", 0, 100), _Ev("k", "CUDA", 10, 20),
              _Ev("Buffer Flush", "CPU", 40, 30), _Ev("k2", "CUDA", 60, 5),
              _Ev("cudaGraphLaunch", "CPU", 70, 30)]
    tr = trace.reduce(events)
    assert trace.idle_ns(tr, 0, 100) == (50, 25)
    run_ = SimpleNamespace(trace=tr, traced=[{}])
    assert frame_idle_pct.read(run_) == pytest.approx(100.0 * 50 / 75)
    gaps = trace.breakdown(tr)["idle_gaps"]
    assert [g[0] for g in gaps] == ["cudaGraphLaunch", "host", "host"]
    assert sum(g[1] for g in gaps) == pytest.approx(50e-9)


def test_kernel_launches_read_across_the_device_clocks_drift():
    """The device clock drifts from the host's: the second frame's K1
    launch reads as starting 0.5 ms before its host span. It still counts
    for that frame, and no frame takes another's."""
    from slambench import work
    from slambench.layer_metrics import k1_roofline

    ms = 1_000_000
    events = [_Ev("slambench.frame", "CPU", 0, 20 * ms),
              _Ev("slambench.frame", "CPU", 100 * ms, 20 * ms),
              _Ev("corner_maps_levels_kernel", "CUDA", 2 * ms, ms // 10),
              _Ev("corner_maps_levels_kernel", "CUDA", 99 * ms + ms // 2, ms // 10)]
    run_ = SimpleNamespace(trace=trace.reduce(events), traced=[{}, {}], work=work,
                           device_name="NVIDIA H100 80GB HBM3",
                           config={"slam": {"image_wh": [640, 480]}})
    wins = [w for _, w in _frames.launch_windows(run_)]
    assert wins == [(-80 * ms, 20 * ms), (20 * ms, 120 * ms)]
    found = [len(trace.ops_in(run_.trace, lo, hi, "corner_maps_levels")) for lo, hi in wins]
    assert found == [1, 1]
    least = 2 * work.k1_bytes((480, 640), 8) / work.peaks(run_.device_name)["hbm_bytes_per_s"]
    assert k1_roofline.read(run_) == pytest.approx(100.0 * least / 2e-4)


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def _synthetic_answers(cell: str):
    """(check.numbers's positional arguments, lens) for answers of the shape
    `run.collect_answers` gives, made from a small render of the cell's
    course: poses off the truth by a few mrad, one frame untracked, two
    frames' features from the reference's own extraction with a tenth of
    the descriptors altered, and noisy observations of random points."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    conf = json.loads((REPO / f"slambench/configs/{w['config']}.json").read_text())
    traffic = json.loads((REPO / f"slambench/traffic/{w['traffic']}.json").read_text())
    cam, wh, n = conf["camera"], (128, 96), 6
    scale = wh[0] / conf["slam"]["image_wh"][0]
    k = np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], np.float32) * scale
    dist = check.camera.coefficients(cam)
    frames, gt = course.render(traffic["scene_seed"], n, traffic["segments"], wh, k, "cpu",
                               tex_size=64, dist=dist)
    rng = np.random.default_rng(5)
    poses = gt.astype(np.float64).copy()
    for p in poses:
        w_ = rng.normal(0, 2e-3, 3)
        W = np.array([[0, -w_[2], w_[1]], [w_[2], 0, -w_[0]], [-w_[1], w_[0], 0]])
        p[:, :3] = (np.eye(3) + W + 0.5 * W @ W) @ p[:, :3]
        p[:, 3] += rng.normal(0, 5e-3, 3)
    tracked = np.array([True, True, False, True, True, True])
    fe = {key: conf["slam"]["frontend"][key] for key in ("n_features", "n_levels",
                                                        "fast_threshold", "steer_mode")}
    lens = None if dist is None else (k, dist)
    feats = {}
    for j in (1, 4):
        ref = check.reference_features(frames[j], fe, "cpu", lens=lens)[0]
        desc = ref["desc"].copy()
        desc[::10, 0] ^= 1
        feats[j] = {"uv": ref["uv"].astype(np.float32),
                    "scale": 1.2 ** ref["level"].astype(np.float32), "desc": desc,
                    "valid": ref["valid"]}
    pts = np.stack([rng.uniform(-2, 2, 60), rng.uniform(-1, 1, 60), rng.uniform(-2, 2, 60)], -1)
    obs = {key: [] for key in ("pose", "k", "uv", "scale", "pid")}
    for f in (0, 1, 3):
        Xc = pts @ gt[f, :, :3].T.astype(np.float64) + gt[f, :, 3]
        ok = Xc[:, 2] > 0.1
        uv = np.stack([k[0] * Xc[ok, 0] / Xc[ok, 2] + k[2],
                       k[1] * Xc[ok, 1] / Xc[ok, 2] + k[3]], -1)
        obs["pose"].append(np.repeat(poses[f][None], ok.sum(), 0).astype(np.float32))
        obs["k"].append(np.repeat(k[None], ok.sum(), 0))
        obs["uv"].append((uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32))
        obs["scale"].append(np.ones(ok.sum(), np.float32))
        obs["pid"].append(np.flatnonzero(ok))
    obs = {key: np.concatenate(v) for key, v in obs.items()}
    ans = {"poses": poses.astype(np.float32), "tracked": tracked, "features": feats, "obs": obs,
           "points": pts.astype(np.float32), "n_resident": n}
    return (ans, gt, dict(enumerate(frames)), fe, "cpu"), lens


# check.numbers on `_synthetic_answers`, as the harness gave them before a
# configuration could name checks of its own
BEFORE_THE_HOOK = {
    "tum1_vga.desk30": {
        False: {
            "kp_mismatch_pct": 12.949640287769784,
            "rpe_mm_p50": 7.6404577565687735,
            "rpe_rot_mrad_p50": 3.873174951690161,
            "rot_over_2.5mrad_pct": 66.66666666666666,
            "reproj_px_mean": 1.5433540624324371,
            "reproj_px_p50": 0.7564935476277843,
        },
        True: {
            "kp_mismatch_pct": 56.16766467065868,
            "rpe_mm_p50": 6.774867925980219,
            "rpe_rot_mrad_p50": 4.748530827573647,
            "rot_over_2.5mrad_pct": 66.66666666666666,
            "reproj_px_mean": 1.4648372676175718,
            "reproj_px_p50": 0.7769818902200603,
        },
    },
    "kitti_wide.orbit10": {
        False: {
            "kp_mismatch_pct": 9.72568578553616,
            "rpe_mm_p50": 7.4963853759200445,
            "rpe_rot_mrad_p50": 3.8689914156912755,
            "rot_over_2.5mrad_pct": 66.66666666666666,
            "reproj_px_mean": 1.221223508599012,
            "reproj_px_p50": 0.7193867562692841,
        },
        True: {
            "kp_mismatch_pct": 61.58285243198681,
            "rpe_mm_p50": 6.39970924306271,
            "rpe_rot_mrad_p50": 4.599117044676786,
            "rot_over_2.5mrad_pct": 66.66666666666666,
            "reproj_px_mean": 1.183066681552336,
            "reproj_px_p50": 0.7415472508275445,
        },
    },
    "euroc_mav.flight20": {
        False: {
            "kp_mismatch_pct": 9.46843853820598,
            "rpe_mm_p50": 7.4963853759200445,
            "rpe_rot_mrad_p50": 3.8689914156912755,
            "rot_over_2.5mrad_pct": 66.66666666666666,
            "reproj_px_mean": 1.2584484958731352,
            "reproj_px_p50": 0.7199980676649306,
        },
        True: {
            "kp_mismatch_pct": 71.95020746887967,
            "rpe_mm_p50": 6.39970924306271,
            "rpe_rot_mrad_p50": 4.599117044676786,
            "rot_over_2.5mrad_pct": 66.66666666666666,
            "reproj_px_mean": 1.2182334714552885,
            "reproj_px_p50": 0.7357878074931542,
        },
    },
}
