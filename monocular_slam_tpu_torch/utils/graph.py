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
  beyond the launch (`Program.replays` counts them). Python's cyclic
  collector is paused while it captures (`gc_paused`). The kernels count
  their own launches on the card (`ops/launches.py`), so a replay is
  counted where it runs. A failure to capture raises: nothing falls back
  to eager runs.
- `Programs`: a session's programs, captured on one stream into one graph
  memory pool, keyed as the reference keys its compiled programs; the
  session's step programs and its loop closer's share it. With a `tracer`
  (`utils/profiling.Tracer`) each capture is a `capture` span.
- `Words` / `Readback`: a program's static control words, refilled from
  pinned host memory with one host-to-device copy, and its small outputs,
  brought back with one device-to-host copy behind an event. On the CPU
  both are plain tensors. `Words.waits` and `Readback.reads` count the
  host's waits on them.

A program's function reads its static inputs and, when it commits, writes
its results into static buffers made outside any capture (the session's
state, `Readback` outputs, carries): memory a capture takes from the
shared pool may be reused by a later capture, so nothing that must outlive
another program's replay lives there.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch


def capturing() -> bool:
    """True while the current CUDA stream records a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic collector off for the block, and back as it was
    after it. A collection inside a capture frees whatever unreachable
    cycles hold; a captured graph freed there invalidates the capture, which
    then fails at its end ("operation failed due to a previous error during
    capture"). torch no longer collects before a capture, so the cycles
    wait for the first collection after it instead."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


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

    replays = 0  # every Program's replays in this process

    def __init__(self, fn, *, stream: torch.cuda.Stream, pool=None):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        stream.synchronize()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with gc_paused(), torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = fn()
        torch.cuda.current_stream().wait_stream(stream)
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        Program.replays += 1
        self.graph.replay()
        return self.outputs


class Programs:
    """The captured programs of one session on one device: one capture
    stream, one shared graph pool (its programs never run concurrently),
    the programs by key and the seconds each capture took."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = None
        self.programs: dict = {}
        self.capture_s: dict = {}
        self.tracer = None

    def get(self, key, fn) -> Program:
        """The program `key`, captured from `fn()` at its first use."""
        prog = self.programs.get(key)
        if prog is None:
            span = None if self.tracer is None else self.tracer.begin("capture", key)
            with torch.inference_mode():
                prog = Program(fn, stream=self.stream, pool=self.pool)
            if span is not None:
                self.tracer.end(span)
            prog.key = key
            if self.pool is None:
                self.pool = prog.graph.pool()
            self.programs[key] = prog
            self.capture_s[key] = prog.capture_s
        return prog

    def drop(self, match) -> int:
        """Drop the programs whose key `match(key)` accepts; their memory
        returns to the pool for the next capture. Returns how many."""
        gone = [key for key in self.programs if match(key)]
        for key in gone:
            del self.programs[key]
        return len(gone)


class Words:
    """A program's static int64 control words on `device`, refilled from a
    pinned host row with one copy (the host waits only if the row's last
    copy has not run yet). 32-bit float words ride bitcast, as the step's
    control row carries k and dist."""

    waits = 0  # every Words' fills in this process that had to wait on the device

    def __init__(self, n: int, device):
        cuda = torch.device(device).type == "cuda"
        with torch.inference_mode(False):  # normal tensors: refilled in and out of it
            self.host = torch.zeros(n, dtype=torch.int64, pin_memory=cuda)
            self.dev = torch.zeros(n, dtype=torch.int64, device=device)
        self.event = torch.cuda.Event() if cuda else None

    def fill(self, *parts) -> torch.Tensor:
        """Write `parts` (ints, int arrays, float32 arrays) in order and copy
        them to the device; returns the device words."""
        if self.event is not None and not self.event.query():
            Words.waits += 1
            self.event.synchronize()
        words = np.concatenate([_words(p) for p in parts])
        row = self.host.numpy()
        row[:] = 0
        row[: words.size] = words
        self.dev.copy_(self.host, non_blocking=True)
        if self.event is not None:
            self.event.record()
        return self.dev


def _words(part) -> np.ndarray:
    a = np.asarray(part)
    if a.dtype == np.float32:
        a = a.view(np.int32)
    return a.reshape(-1).astype(np.int64)


def floats(words: torch.Tensor) -> torch.Tensor:
    """float32 values of control words written from float32 arrays."""
    return words.to(torch.int32).view(torch.float32)


class Readback:
    """A program's static int32 output vector and its host copy: `start()`
    copies it into pinned memory behind an event, `get()` waits for the
    event and returns the host int32 array (a view: copy what you keep
    past the next `start`). `reads` counts the host reads."""

    reads = 0  # every Readback's reads in this process

    def __init__(self, n: int, device):
        cuda = torch.device(device).type == "cuda"
        with torch.inference_mode(False):
            self.dev = torch.zeros(n, dtype=torch.int32, device=device)
            self.host = torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def start(self) -> "Readback":
        self.host.copy_(self.dev, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()
        return self

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        Readback.reads += 1
        return self.host.numpy()


class Statics(dict):
    """A session's (or loop closer's) static program inputs and outputs by
    name, each made outside any capture at its first use: the programs'
    `Words`, `Readback`s and buffers shaped like a given tensor."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    def words(self, name, n: int) -> Words:
        if name not in self:
            self[name] = Words(n, self.device)
        return self[name]

    def readback(self, name, n: int) -> Readback:
        if name not in self:
            self[name] = Readback(n, self.device)
        return self[name]

    def buffer(self, name, like: torch.Tensor) -> torch.Tensor:
        if name not in self:
            with torch.inference_mode(False):
                self[name] = torch.zeros_like(like)
        return self[name]


def pack(ints=(), fl=()) -> torch.Tensor:
    """One int32 vector: the int tensors, then the float tensors' float32
    bits (each flattened)."""
    parts = [x.reshape(-1).to(torch.int32) for x in ints]
    parts += [x.reshape(-1).to(torch.float32).view(torch.int32) for x in fl]
    return torch.cat(parts)


def leaves(tree) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return []


def cloned(tree):
    """`tree` with every tensor cloned (a carry that owns its storage)."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: cloned(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[cloned(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(cloned(v) for v in tree)
    return tree


def copy_leaves(dst: list, tree) -> None:
    """Copy the tensors of `tree` into `dst` (`leaves` of a like tree)."""
    src = leaves(tree)
    if len(src) != len(dst):
        raise ValueError(f"copy_leaves: {len(src)} tensors into {len(dst)}")
    for a, b in zip(dst, src):
        if a is not b:
            a.copy_(b)
