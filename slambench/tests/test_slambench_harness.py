"""The harness on the CPU at a tiny size: a cell added as data only (a
configuration, a traffic mix, a limits file and a per-layer reader, in a
scratch copy of the benchmark) runs through `run_cell` with the session's
plain paths; the result line has the contract's keys; no JAX module is
loaded; a configuration's lens reaches every `add_frame` call, and a
pinhole's none; and `correct` comes out false when the timed path is
broken."""

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

from slambench import control, run, trace
from slambench.layer_metrics import frame_idle_pct

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL = "tiny_vga.tiny10"
LENS_CELL = "tiny_mav.tiny10"  # EuRoC's camera at half its size, lens as published
WARMUP = 15
LIMITS = {"kp_mismatch_pct": 1.0, "rpe_rot_mrad_p50": 3.0, "rot_over_2.5mrad_pct": 60.0}
READER = '''
def read(run):
    return float(len(run.frames)) if run.frames else None
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
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    conf = json.loads((REPO / "slambench/configs/tum1_vga.json").read_text())
    conf["slam"].update(image_wh=[320, 240], max_points=4000, max_slots=None)
    conf["slam"]["frontend"]["n_features"] = 500
    conf["camera"].update(fx=258.653, fy=258.235, cx=159.32, cy=127.66)
    (dst / "slambench/configs/tiny_vga.json").write_text(json.dumps(conf))
    conf = json.loads((REPO / "slambench/configs/euroc_mav.json").read_text())
    conf["slam"].update(image_wh=[376, 240], max_points=4000, max_slots=None)
    conf["slam"]["frontend"]["n_features"] = 500
    conf["camera"].update(fx=229.327, fy=228.648, cx=183.6075, cy=124.1875)
    (dst / "slambench/configs/tiny_mav.json").write_text(json.dumps(conf))
    (dst / "slambench/traffic/tiny10.json").write_text(json.dumps({
        "rate_hz": 10.0, "warmup_frames": WARMUP, "segments": [[0, 0.01]], "scene_seed": 7,
        "trace_frames": 3, "check_frames": 2, "texture_size": 256}))
    for cell in (CELL, LENS_CELL):
        (dst / f"slambench/limits/{cell}.json").write_text(json.dumps(LIMITS))
    (dst / "slambench/layer_metrics/frames_seen.py").write_text(READER)
    return dst


def _run(root, trace=False, seed=7, cell=CELL):
    torch.set_num_threads(2)
    return run.run_cell(cell, seed, 1.0, trace, device="cpu", root=root)


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


@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_keypoints", "pose_altered",
                                   "keyframe_pose_altered", "lens_withheld"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    from monocular_slam_tpu_torch.ops import features
    from monocular_slam_tpu_torch.slam import session

    cell = CELL
    if fault == "lens_withheld":
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
