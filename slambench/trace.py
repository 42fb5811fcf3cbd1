"""Reduction of a `torch.profiler` trace of the traced frames to what the
per-layer readers and the result's `device` and `breakdown` need: the
device's operations, the harness's frame spans, the host's operations
that name an idle gap, and the profiler's own host work (its activity
buffers' requests and flushes), which is neither the program's idle time
nor its work and is left out of both."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME_SPAN = "slambench.frame"
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


class Trace(NamedTuple):
    names: list  # device operation names
    op_name: np.ndarray  # (n,) index into names
    op_start: np.ndarray  # (n,) ns
    op_end: np.ndarray  # (n,) ns
    busy: np.ndarray  # (m, 2) merged device busy intervals, ns
    frames: np.ndarray  # (f, 2) host spans of the traced frames, ns, in order
    host: list  # (start ns, end ns, name) of host operations inside the frames
    covered: np.ndarray  # (k, 2) merged intervals of device work or the profiler's own, ns


def reduce(events) -> Trace:
    """A `Trace` of kineto events (`prof.profiler.kineto_results.events()`)."""
    names, index, ops, frames, host, own = [], {}, [], [], [], []
    for e in events:
        # torch 2.11's events carry no activity type: tell them by device and
        # name (the harness's and the profiler's annotations are no device work)
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        annotation = (name == FRAME_SPAN or name.startswith("ProfilerStep")
                      or (hasattr(e, "is_user_annotation") and e.is_user_annotation()))
        if "CUDA" in str(e.device_type()):
            if annotation or (kind is not None and kind not in DEVICE_KINDS):
                continue
            if name not in index:
                index[name] = len(names)
                names.append(name)
            ops.append((index[name], start, start + dur))
        elif name == FRAME_SPAN and "CPU" in str(e.device_type()):
            frames.append((start, start + dur))
        elif name in PROFILER_OWN:
            own.append((start, start + dur))
        elif not annotation:
            host.append((start, start + dur, name))
    arr = np.array(ops, np.int64).reshape(-1, 3)
    arr = arr[np.argsort(arr[:, 1], kind="stable")]
    frames = np.array(sorted(frames), np.int64).reshape(-1, 2)
    if len(frames):
        lo, hi = frames[0, 0], frames[-1, 1]
        host = [h for h in host if h[1] > lo and h[0] < hi]
    iv = np.concatenate([arr[:, 1:], np.array(own, np.int64).reshape(-1, 2)])
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    return Trace(names, arr[:, 0], arr[:, 1], arr[:, 2], _merge(arr[:, 1], arr[:, 2]), frames,
                 host, _merge(iv[:, 0], iv[:, 1]))


def _merge(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    out = []
    for s, e in zip(start.tolist(), end.tolist()):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, np.int64).reshape(-1, 2)


def _overlap(iv: np.ndarray, lo: int, hi: int) -> int:
    return int(np.clip(np.minimum(iv[:, 1], hi) - np.maximum(iv[:, 0], lo), 0, None).sum())


def busy_ns(tr: Trace, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some device operation ran."""
    return _overlap(tr.busy, lo, hi)


def idle_ns(tr: Trace, lo: int, hi: int) -> tuple[int, int]:
    """(idle, profiler's own) nanoseconds of [lo, hi): idle when neither a
    device operation nor the profiler's own host work ran; the profiler's
    own where it ran and no device operation did."""
    covered = _overlap(tr.covered, lo, hi)
    return (hi - lo) - covered, covered - _overlap(tr.busy, lo, hi)


def ops_in(tr: Trace, lo: int, hi: int, pattern: str) -> np.ndarray:
    """Durations (ns) of the device operations whose name holds `pattern`
    and that start in [lo, hi)."""
    ids = [i for i, n in enumerate(tr.names) if pattern in n]
    sel = np.isin(tr.op_name, ids) & (tr.op_start >= lo) & (tr.op_start < hi)
    return (tr.op_end - tr.op_start)[sel]


def window(tr: Trace) -> tuple[int, int]:
    """The traced window: from the first traced frame's start to the last's
    end (ns)."""
    return int(tr.frames[0, 0]), int(tr.frames[-1, 1])


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the traced window, and
    the longest idle gaps inside the traced frames, each named by the
    shortest host operation that covers its middle (seconds); the
    profiler's own host work is no gap."""
    lo, hi = window(tr)
    inside = (tr.op_start >= lo) & (tr.op_start < hi)
    tot = np.bincount(tr.op_name[inside], weights=(tr.op_end - tr.op_start)[inside],
                      minlength=len(tr.names))
    order = np.argsort(-tot)[:top]
    device_ops = [[tr.names[i], float(tot[i]) * 1e-9] for i in order if tot[i] > 0]
    gaps = []
    for f_lo, f_hi in tr.frames.tolist():
        edges = [f_lo]
        b = tr.covered[(tr.covered[:, 1] > f_lo) & (tr.covered[:, 0] < f_hi)]
        for s, e in b.tolist():
            edges += [max(s, f_lo), min(e, f_hi)]
        edges.append(f_hi)
        gaps += [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    idle = []
    for dur, start in gaps[:top]:
        mid = start + dur // 2
        cover = [h for h in tr.host if h[0] <= mid < h[1]]
        name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host"
        idle.append([name, dur * 1e-9])
    return {"device_ops": device_ops, "idle_gaps": idle}
