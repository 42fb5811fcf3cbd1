"""Observability: per-stage timing + BA iteration statistics (counterpart
of `monocular_slam_tpu/utils/profiling.py`).

Mirrors g2o's `G2OBatchStatistics` (`ThirdParty/g2o/g2o/core/batch_stats.h`,
populated per LM iteration at `optimization_algorithm_levenberg.cpp:76-118`)
and the verbose iteration log (`sparse_optimizer.cpp:399-411`): chi2, lambda,
accept/reject per iteration come from `BAResult`. `Tracer` is a session's
recorder (`SlamSession(..., trace=True)`): host spans of each frame on the
profiler's clock, the device's clock at the parts of the tracked step
inside its programs, and per-frame counters of host waits, replays and
captures. `device_trace` captures a `torch.profiler` trace (CPU and CUDA
activity) around any block and writes it for TensorBoard and
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BAIterationStats:
    """Per-iteration LM record (the G2OBatchStatistics analog)."""

    iteration: int
    chi2: float
    lam: float
    accepted: bool


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def ba_stats(result) -> list[BAIterationStats]:
    """Explode a BAResult / PoseGraphResult chi2 history into records."""
    chi2 = _np(result.chi2_history)
    lam = _np(getattr(result, "lambda_history", np.full_like(chi2, np.nan)))
    acc = _np(getattr(result, "accepted", np.ones_like(chi2, bool)))
    return [
        BAIterationStats(i, float(chi2[i]), float(lam[i]), bool(acc[i]))
        for i in range(len(chi2))
    ]


def format_ba_log(result, name: str = "BA") -> str:
    """g2o-style verbose iteration log."""
    lines = [f"[{name}] chi2_initial = {float(result.chi2_initial):.6g}"]
    for s in ba_stats(result):
        lines.append(
            f"[{name}] iter {s.iteration:3d}  chi2 {s.chi2:.6g}  "
            f"lambda {s.lam:.3g}  {'accept' if s.accepted else 'reject'}"
        )
    return "\n".join(lines)


# the device stamps of a tracked step: slot k holds the clock at the end of
# part SLOTS[k]; the track and mapping programs' starts are slots 0 and 3
SLOTS = ("track_start", "front_end", "tracker", "map_start", "fuse", "local_ba", "cull",
         "detect_pack")
PARTS = SLOTS[1:3] + SLOTS[4:]  # the keys of `stamp_ms`
COUNTERS = ("host_syncs", "replays", "captures")


def stamp_ms(stamps) -> dict:
    """Milliseconds of each part of one tracked step that ran, from its row
    of stamps (`SLOTS`; a part that did not run holds 0): the front end and
    the tracker from the track program's start, each part of the mapping
    program from the stamp before it in time (the mapping block's parts run
    in the configuration's order)."""
    s = [int(x) for x in stamps]
    out = {}
    if s[0] and s[1]:
        out["front_end"] = (s[1] - s[0]) * 1e-6
        if s[2]:
            out["tracker"] = (s[2] - s[1]) * 1e-6
    prev = s[3]
    if prev:
        for t, k in sorted((s[k], k) for k in range(4, len(SLOTS)) if s[k]):
            out[SLOTS[k]] = (t - prev) * 1e-6
            prev = t
    return out


class Tracer:
    """A session's spans and per-frame counters, kept in memory until
    `export()` or `to_chrome()`.

    A span is [name, key, start_ns, end_ns, frame, parent]: a program's
    `key` or None, its host interval on `time.time_ns()` (end 0 while
    open), the clock `torch.profiler` stamps its host events with (up to
    the profiler's conversion of its own clock, 0.2 ms on the H100's torch
    2.11), the frame it belongs to (`frame` when it began) and the index of
    the span open around it (-1 for none). `begin` opens one, `end` closes
    it with any still open inside it. `counters` holds each frame's
    counters (`COUNTERS`).

    `stamps` is the `device` buffer of a tracked step's stamps (`SLOTS`),
    written by `mark` inside the step: on a card by `ops/span_stamp`'s
    kernel (built here), on the CPU with the host's clock; each frame's
    copy is read into its `FrameStats.device_ms`."""

    def __init__(self, device):
        self.spans: list[list] = []
        self._open: list[int] = []
        self.frame = -1
        self.counters: dict[int, dict] = {}
        with torch.inference_mode(False):  # written in and out of it
            self.stamps = torch.zeros(len(SLOTS), dtype=torch.int64, device=device)
        if self.stamps.is_cuda:
            from monocular_slam_tpu_torch.ops import span_stamp

            span_stamp.load()

    def begin(self, name: str, key=None) -> int:
        """Open span `name` (with a program's `key`); returns its index."""
        self.spans.append([name, key, time.time_ns(), 0, self.frame,
                           self._open[-1] if self._open else -1])
        self._open.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def end(self, idx: int) -> None:
        """Close span `idx`, and every span still open inside it."""
        if idx not in self._open:
            raise ValueError(f"span {idx} is not open")
        t = time.time_ns()
        while True:
            top = self._open.pop()
            self.spans[top][3] = t
            if top == idx:
                return

    @contextlib.contextmanager
    def span(self, name: str, key=None):
        idx = self.begin(name, key)
        try:
            yield idx
        finally:
            self.end(idx)

    def mark(self, part: str) -> None:
        """The device's clock (the host's on the CPU) at the end of `part`
        of the tracked step into its slot of `stamps`; the track program's
        start clears the later slots."""
        from monocular_slam_tpu_torch.ops import span_stamp

        k = SLOTS.index(part)
        span_stamp.stamp(self.stamps, k, len(SLOTS) - 1 if k == 0 else 0)

    def export(self, stats=(), frames=None) -> dict:
        """The closed spans (of `frames` only, when given) as arrays:
        `name`, `key` (str, "" for none), `start_ns`, `end_ns`, `frame`,
        `parent` and `index` (parents refer to indices); each frame's
        counters, and the device milliseconds of the `FrameStats` in
        `stats` that have them (NaN where a part did not run), one row per
        frame."""
        fset = None if frames is None else {int(f) for f in frames}
        idx = [i for i, s in enumerate(self.spans) if s[3] and (fset is None or s[4] in fset)]
        cols = list(zip(*(self.spans[i] for i in idx))) or [()] * 6
        spans = {"name": np.array(cols[0], object),
                 "key": np.array(["" if k is None else str(k) for k in cols[1]], object),
                 "index": np.array(idx, np.int64)}
        for n, col in zip(("start_ns", "end_ns", "frame", "parent"), cols[2:]):
            spans[n] = np.array(col, np.int64)
        device_ms = {st.frame: st.device_ms for st in stats if st.device_ms is not None}

        def by_frame(table: dict, keys) -> dict:
            fs = sorted(f for f in table if fset is None or f in fset)
            out = {"frame": np.array(fs, np.int64)}
            for k in keys:
                out[k] = np.array([table[f].get(k, np.nan) for f in fs], np.float64)
            return out

        return {"spans": spans, "counters": by_frame(self.counters, COUNTERS),
                "device_ms": by_frame(device_ms, PARTS)}

    def to_chrome(self, path: str, stats=(), base_ns: int = 0) -> None:
        """Write the spans as Chrome trace events ("X", microseconds from
        `base_ns`: give a `torch.profiler` trace's `baseTimeNanoseconds` to
        lay both on one time axis), each frame's counters ("C") and, on its
        `frame` span, its device milliseconds from `stats`."""
        import json
        import os

        pid = os.getpid()
        device_ms = {st.frame: st.device_ms for st in stats if st.device_ms is not None}
        frame_start = {}
        events = []
        for name, key, t0, t1, f, _ in self.spans:
            if not t1:
                continue
            args = {"frame": f}
            if key is not None:
                args["key"] = str(key)
            if name == "frame":
                frame_start[f] = t0
                args.update(device_ms.get(f, {}))
            events.append({"name": name, "cat": "slam", "ph": "X", "pid": pid, "tid": "session",
                           "ts": (t0 - base_ns) / 1e3, "dur": (t1 - t0) / 1e3, "args": args})
        for f, vals in self.counters.items():
            if f in frame_start:
                events += [{"name": k, "cat": "slam", "ph": "C", "pid": pid,
                            "ts": (frame_start[f] - base_ns) / 1e3, "args": {k: v}}
                           for k, v in vals.items()]
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                       "displayTimeUnit": "ms"}, fh)


def chrome_base_ns(path: str) -> int:
    """The `baseTimeNanoseconds` of a Chrome trace that `torch.profiler`
    wrote (its events' microseconds count from it), 0 where it has none."""
    import json

    with open(path) as fh:
        return int(json.load(fh).get("baseTimeNanoseconds", 0))


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a `torch.profiler` trace (CPU and, with a card, CUDA
    activity) around a block; writes `<logdir>/trace.json` (Chrome trace
    format, readable by TensorBoard's profiler plugin and chrome://tracing)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
