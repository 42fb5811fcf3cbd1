"""The session's tracer on the CPU (`utils/profiling.Tracer`,
`SlamSession(..., trace=True)`): tracing off records nothing and changes no
pose; every span of a frame lies inside its `frame` span, and what the
lagged processing runs carries the frame it processes; the spans sit on
`torch.profiler`'s clock; the stamps' arithmetic (`profiling.stamp_ms`,
`ops/span_stamp`'s plain version); the tracer's export and Chrome trace.
The card's side (the stamp kernel inside the captured programs, the node
counts with tracing off) is in `test_torch_cuda.py`."""

import json

import numpy as np
import pytest
import torch

from monocular_slam_tpu_torch.datasets import synthetic as tsyn
from monocular_slam_tpu_torch.ops import span_stamp
from monocular_slam_tpu_torch.retrieval import vocabulary
from monocular_slam_tpu_torch.slam import config as tconf
from monocular_slam_tpu_torch.slam import loop_closer as tlc
from monocular_slam_tpu_torch.slam import session as tsess
from monocular_slam_tpu_torch.utils import prng, profiling
from port_util import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES = 24


def _course(trace: bool):
    """A 24-frame feature course through a session with a loop closer that
    culls keyframes at every keyframe, so that the lagged processing runs
    FrameCulling's program."""
    cfg = tconf.SlamConfig(
        frontend=tconf.FrontendConfig(n_features=300, steer_mode="binned"),
        ba=tconf.BAConfig(window=3, local_iters=2), track=tconf.TrackConfig(pnp_iters=64),
        mapping=tconf.MappingConfig(kf_cull_every=1, kf_keep_recent=1),
        max_frames=32, max_points=4000)
    seq = tsyn.feature_sequence(prng.PRNGKey(0), n_frames=N_FRAMES, n_features=300,
                                device="cpu", ang_step=0.08)
    lc = tlc.LoopCloser(vocabulary.load_default("cpu"), cfg, device="cpu")
    sess = tsess.SlamSession(cfg, seed=0, device="cpu", trace=trace, loop_closer=lc)
    for i in range(N_FRAMES):
        sess.add_frame_features(seq.frames[i], seq.k, float(i))
    poses, valid, _ = sess.trajectory()
    return sess, poses, valid


@pytest.fixture(scope="module")
def runs():
    return {trace: _course(trace) for trace in (False, True)}


def test_tracing_off_records_nothing_and_changes_no_pose(runs):
    off, on = runs[False][0], runs[True][0]
    assert off.tracer is None and all(r.stamps is None for r in off._ring)
    assert all(st.device_ms is None for st in off.stats)
    np.testing.assert_array_equal(runs[False][1], runs[True][1])
    np.testing.assert_array_equal(runs[False][2], runs[True][2])
    assert runs[True][2].all()
    assert [st.is_keyframe for st in off.stats] == [st.is_keyframe for st in on.stats]
    ex = on.tracer.export(on.stats)
    assert list(ex["counters"]["frame"]) == list(range(N_FRAMES))
    tracked = [st.frame for st in on.stats if st.device_ms is not None]
    assert tracked == list(range(2, N_FRAMES))
    assert list(ex["device_ms"]["frame"]) == tracked


def test_every_span_lies_inside_its_frame_span(runs):
    sess = runs[True][0]
    sp = sess.tracer.export()["spans"]
    at = {int(i): k for k, i in enumerate(sp["index"])}
    frames = {}
    for k in range(len(sp["index"])):
        assert sp["start_ns"][k] <= sp["end_ns"][k]
        p = int(sp["parent"][k])
        if p < 0:
            # outside `add_frame` only the final drain (`trajectory`) runs
            assert sp["name"][k] in ("frame", "drain"), sp["name"][k]
            if sp["name"][k] == "frame":
                frames[int(sp["frame"][k])] = k
            continue
        q = at[p]
        assert sp["start_ns"][q] <= sp["start_ns"][k] <= sp["end_ns"][k] <= sp["end_ns"][q]
        root = q
        while sp["parent"][root] >= 0:
            root = at[int(sp["parent"][root])]
        if sp["name"][root] == "frame" and sp["name"][k] in ("prep", "drain", "launch.track",
                                                             "wait.flags", "launch.map"):
            assert sp["frame"][k] == sp["frame"][root]
    assert sorted(frames) == list(range(N_FRAMES))
    # every frame has its prep and its drain; the untracked frames their programs
    for name in ("prep", "drain"):
        assert sorted(int(f) for f, n, p in zip(sp["frame"], sp["name"], sp["parent"])
                      if n == name and p >= 0) == list(range(N_FRAMES))
    kinds = [(str(n), int(f)) for n, f in zip(sp["name"], sp["frame"]) if n.startswith("program.")]
    assert ("program.ingest", 0) in kinds and ("program.bootstrap", 1) in kinds


def test_drain_children_carry_the_frame_they_process(runs):
    sess = runs[True][0]
    sp = sess.tracer.export()["spans"]
    at = {int(i): k for k, i in enumerate(sp["index"])}
    lag = sess.cfg.stat_lag
    culls = [k for k in range(len(sp["index"])) if sp["name"][k] == "program.cull"]
    assert culls, "the course runs FrameCulling's program"
    keyframes = {st.frame for st in sess.stats if st.is_keyframe}
    for k in culls:
        drain = at[int(sp["parent"][k])]
        assert sp["name"][drain] == "drain"
        frame_span = at[int(sp["parent"][drain])]
        # dispatched while processing a keyframe's outcome, `stat_lag` frames late
        assert int(sp["frame"][k]) in keyframes
        assert int(sp["frame"][frame_span]) == int(sp["frame"][k]) + lag
        assert sp["key"][k].startswith("('cull'")


def test_frame_span_on_the_profilers_clock():
    """A `frame` span recorded inside a `record_function` block, 20 ms from
    either end, lies inside that block's interval among the profiler's
    events: the tracer's clock is the profiler's, up to the profiler's
    conversion of its own clock (0.2 ms on the card's torch; another clock
    would differ by its epoch)."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    tr = profiling.Tracer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            time.sleep(0.02)
            with tr.span("frame"):
                torch.ones(64).sum()
            time.sleep(0.02)
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    assert len(ev) == 1
    lo, hi = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    sp = tr.export()["spans"]
    assert lo <= sp["start_ns"][0] <= sp["end_ns"][0] <= hi, (lo, hi, sp)


def _stamps(**ns):
    row = np.zeros(len(profiling.SLOTS), np.int64)
    for name, t in ns.items():
        row[profiling.SLOTS.index(name)] = t
    return row


@pytest.mark.parametrize("case", ["keyframe", "tracked_only", "per_frame_order", "no_map"])
def test_stamp_arithmetic(case):
    ms = 1_000_000
    if case == "keyframe":  # fuse -> local BA -> cull, then detection and the packed vector
        row = _stamps(track_start=10 * ms, front_end=13 * ms, tracker=21 * ms, map_start=22 * ms,
                      fuse=23 * ms, local_ba=29 * ms, cull=30 * ms, detect_pack=31 * ms)
        want = dict(front_end=3, tracker=8, fuse=1, local_ba=6, cull=1, detect_pack=1)
    elif case == "tracked_only":  # the mapping block's parts did not run
        row = _stamps(track_start=10 * ms, front_end=12 * ms, tracker=20 * ms, map_start=20 * ms,
                      detect_pack=21 * ms)
        want = dict(front_end=2, tracker=8, detect_pack=1)
    elif case == "per_frame_order":  # local BA -> fuse -> cull
        row = _stamps(track_start=0, front_end=3 * ms, tracker=9 * ms, map_start=10 * ms,
                      local_ba=15 * ms, fuse=17 * ms, cull=18 * ms, detect_pack=19 * ms)
        row[0] = 1  # a stamp of 0 reads as "did not run"
        want = dict(front_end=3 - 1e-6, tracker=6, local_ba=5, fuse=2, cull=1, detect_pack=1)
    else:  # the track program's stamps only
        row = _stamps(track_start=5 * ms, front_end=7 * ms, tracker=9 * ms)
        want = dict(front_end=2, tracker=2)
    got = profiling.stamp_ms(row)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k


def test_plain_stamp_writes_the_host_clock_and_clears():
    import time

    buf = torch.full((len(profiling.SLOTS),), 7, dtype=torch.int64)
    t0 = time.time_ns()
    span_stamp.stamp(buf, 0, len(profiling.SLOTS) - 1)
    span_stamp.stamp(buf, 2)
    t1 = time.time_ns()
    assert t0 <= int(buf[0]) <= int(buf[2]) <= t1
    assert buf[1] == 0 and (buf[3:] == 0).all()
    with pytest.raises(ValueError):
        span_stamp.stamp(buf, 7, 1)
    with pytest.raises(ValueError):
        span_stamp.stamp(buf.to(torch.int32), 0)
    # the tracer's marks: the track program's start clears every later slot
    tr = profiling.Tracer("cpu")
    tr.stamps.fill_(3)
    tr.mark("track_start")
    tr.mark("front_end")
    assert (tr.stamps[2:] == 0).all() and 0 < int(tr.stamps[0]) <= int(tr.stamps[1])
    assert set(profiling.stamp_ms(tr.stamps.numpy())) == {"front_end"}


def test_tracer_nesting_export_and_chrome(tmp_path):
    tr = profiling.Tracer("cpu")
    tr.frame = 4
    f = tr.begin("frame")
    with tr.span("prep"):
        pass
    d = tr.begin("drain")
    tr.frame = 1
    tr.begin("program.cull", ("cull", 128))
    tr.end(f)  # closes the drain and the program inside it too
    with pytest.raises(ValueError):
        tr.end(d)  # already closed
    tr.counters[4] = {"host_syncs": 1, "replays": 2, "captures": 0}
    stats = [tsess.FrameStats(3), tsess.FrameStats(4, device_ms={"front_end": 3.0, "tracker": 8.0})]
    tr.begin("open")  # never closed: not exported
    ex = tr.export(stats)
    sp = ex["spans"]
    assert list(sp["name"]) == ["frame", "prep", "drain", "program.cull"]
    assert list(sp["parent"]) == [-1, f, f, d] and list(sp["frame"]) == [4, 4, 4, 1]
    assert list(sp["key"]) == ["", "", "", "('cull', 128)"]
    assert sp["end_ns"][0] == sp["end_ns"][2] == sp["end_ns"][3]
    assert list(tr.export(frames=[1])["spans"]["name"]) == ["program.cull"]
    assert ex["counters"]["replays"].tolist() == [2.0]
    assert np.isnan(ex["device_ms"]["fuse"][0]) and ex["device_ms"]["tracker"][0] == 8.0
    path = tmp_path / "spans.json"
    tr.to_chrome(str(path), stats, base_ns=int(sp["start_ns"][0]))
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["frame", "prep", "drain", "program.cull"]
    assert xs[0]["ts"] == 0 and xs[0]["args"]["tracker"] == 8.0
    assert xs[3]["args"] == {"frame": 1, "key": "('cull', 128)"}
    cs = {e["name"]: e["args"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert cs == {"host_syncs": {"host_syncs": 1}, "replays": {"replays": 2},
                  "captures": {"captures": 0}}
    assert doc["baseTimeNanoseconds"] == int(sp["start_ns"][0])


def test_cli_profile_writes_spans_beside_the_trace(tmp_path):
    """`run.py --profile LOGDIR` traces the session and writes
    `spans.json` beside the profiler's `trace.json`, on its time base: each
    frame's span lies inside the profiled main loop."""
    import contextlib
    import io

    from monocular_slam_tpu_torch import run as trun

    logdir = tmp_path / "prof"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = trun.main(["--dataset", "synthetic", "--end", "6", "--features", "300",
                        "--max-frames", "16", "--max-points", "3000", "--step", "1",
                        "--out", str(tmp_path / "out"), "--device", "cpu",
                        "--profile", str(logdir)])
    assert rc == 0
    trace = json.loads((logdir / "trace.json").read_text())
    spans = json.loads((logdir / "spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    ts = [e["ts"] for e in trace["traceEvents"] if "ts" in e and e.get("ph") == "X"]
    frames = [e for e in spans["traceEvents"] if e["name"] == "frame"]
    assert [e["args"]["frame"] for e in frames] == list(range(6))
    # the profiler's host events and the spans on one axis (within its 0.2 ms
    # conversion of its own clock)
    assert min(ts) - 1e3 <= frames[0]["ts"] and frames[-1]["ts"] <= max(ts) + 1e3
    counters = {e["name"] for e in spans["traceEvents"] if e["ph"] == "C"}
    assert counters == set(profiling.COUNTERS)
