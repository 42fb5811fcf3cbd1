"""The device's clock at a point of a stream (`csrc/span_stamp.cu`), for the
session's tracer (`utils/profiling.Tracer`).

`stamp(buf, k, n_clear)` writes the time into slot k of an int64 buffer
and zeroes the `n_clear` slots after it:

  - on a CUDA buffer it launches the kernel on the current stream (inside
    a capture it becomes a node of the graph), which reads `%globaltimer`
    once every operation before it on the stream has finished; a kernel
    that fails to build or launch raises;
  - on a CPU buffer (the session's op-by-op route) it writes
    `time.time_ns()` at the call.

The kernel counts no launches (`ops/launches.py` counts the main path's
kernels) and is built only when a session traces. It is compiled at first
use with `nvcc` for `sm_90a` into a shared library with a plain C
interface, under `_build/` beside this package, and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import time

import torch

from monocular_slam_tpu_torch.utils import cuda_build

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = cuda_build.load("span_stamp", BUILD_INFO, "launch_span_stamp", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _lib


def stamp(buf: torch.Tensor, k: int, n_clear: int = 0) -> None:
    """The time into slot k of the int64 buffer `buf` and 0 into the next
    `n_clear` slots: the device's clock on a card, the host's on the CPU."""
    if (buf.dtype != torch.int64 or buf.dim() != 1
            or not (0 <= k and 0 <= n_clear and k + n_clear < len(buf))):
        raise ValueError(f"stamp: slot {k} and {n_clear} after it of a 1-D int64 buffer, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if not buf.is_cuda:
        buf[k] = time.time_ns()
        buf[k + 1: k + 1 + n_clear] = 0
        return
    err = load().launch_span_stamp(buf.data_ptr(), k, n_clear, cuda_build.current_stream())
    if err != 0:
        raise RuntimeError(f"launch_span_stamp failed: CUDA error {err}")
