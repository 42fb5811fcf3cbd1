"""Observability: per-stage timing + BA iteration statistics (counterpart
of `monocular_slam_tpu/utils/profiling.py`).

Mirrors g2o's `G2OBatchStatistics` (`ThirdParty/g2o/g2o/core/batch_stats.h`,
populated per LM iteration at `optimization_algorithm_levenberg.cpp:76-118`)
and the verbose iteration log (`sparse_optimizer.cpp:399-411`): chi2, lambda,
accept/reject per iteration come from `BAResult`; wall-clock per pipeline
stage comes from the host-side `StageTimer`, which synchronizes the CUDA
device of the tensor it is told to wait on. `device_trace` captures a
`torch.profiler` trace (CPU and CUDA activity) around any block and writes
it for TensorBoard and chrome://tracing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

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


@dataclass
class StageTimer:
    """Accumulating wall-clock timer per named stage; with `block_on` (a
    tensor or a tuple/list/dict of them) it synchronizes their CUDA devices
    so timings reflect execution, not dispatch."""

    sync: bool = True
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if self.sync and block_on is not None:
            block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        rows = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            rows.append(f"{name:24s} {tot:8.3f}s total  {tot / max(n, 1) * 1e3:8.2f} ms/call  x{n}")
        return "\n".join(rows)

    def ms_per_call(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1) * 1e3


def block_until_ready(x) -> None:
    """Synchronize the CUDA device of every tensor in `x` (nested tuples,
    lists and dicts); CPU tensors are ready already."""
    if torch.is_tensor(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            block_until_ready(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            block_until_ready(v)


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
