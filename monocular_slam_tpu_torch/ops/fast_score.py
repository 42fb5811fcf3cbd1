"""K1: fused FAST-9 score + 3x3 NMS, as a CUDA kernel written for Hopper
(counterpart of `monocular_slam_tpu/ops/pallas/fast_score.py:corner_maps`).

`corner_maps(img, threshold)` returns (nms_score, raw_score) for one
(H, W) float32 image:

  - on a CUDA tensor it launches the kernel in `csrc/fast_score.cu` on the
    current stream and adds one to `LAUNCHES`; anything the kernel does not
    take raises, and a kernel that fails to build or launch raises;
  - on a CPU tensor it returns `corner_maps_plain`, the same maps from the
    whole-image tensor forms of `ops/fast.py`.

The kernel is compiled at first use with `nvcc` for `sm_90a` into a shared
library with a plain C interface, under `_build/` beside this package and
keyed by a hash of the source, and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes

import torch

from monocular_slam_tpu_torch.ops import fast
from monocular_slam_tpu_torch.utils import cuda_build

LAUNCHES = 0  # kernel launches by `corner_maps` in this process

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log


def corner_maps_plain(img: torch.Tensor, threshold: float = 20.0):
    """(nms, raw) maps by the plain tensor formulation."""
    return fast.nms3(fast.corner_score(img, threshold)), fast.corner_score_raw(img)


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = cuda_build.load("fast_score", BUILD_INFO, "fast_corner_maps", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ])
    return _lib


def corner_maps(img: torch.Tensor, threshold: float = 20.0):
    """(nms_score, raw_score) maps of one (H, W) float32 image. The nms map
    equals `fast.nms3(fast.corner_score(img, threshold))`; the raw map
    equals `fast.corner_score_raw(img)` at least 3 pixels from the edge."""
    global LAUNCHES
    if img.device.type == "cpu":
        return corner_maps_plain(img, threshold)
    if img.device.type != "cuda":
        raise ValueError(f"corner_maps: unsupported device {img.device}")
    if img.dim() != 2 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(
            f"corner_maps takes a contiguous 2-D float32 tensor, got "
            f"{tuple(img.shape)} {img.dtype} contiguous={img.is_contiguous()}"
        )
    H, W = img.shape
    if H == 0 or W == 0:
        raise ValueError("corner_maps: empty image")
    lib = load()
    nms = torch.empty_like(img)
    raw = torch.empty_like(img)
    with torch.cuda.device(img.device):
        err = lib.fast_corner_maps(
            img.data_ptr(), nms.data_ptr(), raw.data_ptr(), H, W,
            float(threshold), cuda_build.stream_of(img),
        )
    if err != 0:
        raise RuntimeError(f"fast_corner_maps launch failed: CUDA error {err}")
    LAUNCHES += 1
    return nms, raw
