"""CUDA graphs for the session's per-frame step (the counterpart of the
reference's `jax.jit` of the step and of `lax.cond` inside it).

- `cond(pred, true_fn, false_fn, *operands)`: one of two branches. With a
  host bool it runs that branch; with a 0-d bool tensor it reads the
  predicate on the host and runs one branch. Inside a capture it raises:
  torch 2.11, the card's, has no conditional graph nodes
  (`CUDAGraph.begin_capture_to_if_node` arrived in a later torch), so a
  captured program ends where the step branches, and the session reads
  the predicates on the host and replays the program of the branch they
  select (`slam/session.py`).
- `Program`: a function of static device tensors captured once into a
  `torch.cuda.CUDAGraph` after a warm-up run on the capture stream (a
  first run loads libraries and fills caches, which a capture must not
  do); each `replay()` reruns it on the current stream with no host work
  beyond the launch. The kernels count their own launches on the card
  (`ops/launches.py`), so a replay is counted where it runs. A failure to
  capture raises: nothing falls back to eager runs.
"""

from __future__ import annotations

import time

import torch


def capturing() -> bool:
    """True while the current CUDA stream records a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def cond(pred, true_fn, false_fn, *operands):
    """`true_fn(*operands)` where `pred` (a host bool or a 0-d bool tensor)
    holds, else `false_fn(*operands)`; both return the same structure."""
    if not torch.is_tensor(pred):
        return true_fn(*operands) if pred else false_fn(*operands)
    if capturing():
        raise RuntimeError("graph.cond on a device predicate inside a capture: this torch has no "
                           "conditional graph nodes; end the program before the branch and decide "
                           "on the host")
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


class Program:
    """`fn()` captured into one CUDA graph. `fn` reads and writes static
    device tensors (refill its inputs in place between replays) and returns
    the static tensors the graph leaves its results in (`outputs`). The
    constructor runs `fn` once eagerly on `stream`, then captures it on the
    same stream into `pool` (a graph memory pool the session's programs
    share; they never run concurrently). `capture_s` is the seconds the
    capture took."""

    def __init__(self, fn, *, stream: torch.cuda.Stream, pool=None):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        stream.synchronize()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = fn()
        torch.cuda.current_stream().wait_stream(stream)
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        self.graph.replay()
        return self.outputs
