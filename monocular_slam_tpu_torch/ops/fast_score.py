"""K1: fused FAST-9 score + 3x3 NMS over every pyramid level of a frame, as
a CUDA kernel written for Hopper (counterpart of
`monocular_slam_tpu/ops/pallas/fast_score.py:corner_maps`).

`corner_maps_levels(levels, threshold)` returns one (nms_score, raw_score)
pair per (H_l, W_l) float32 level:

  - on CUDA tensors it launches the kernel in `csrc/fast_score.cu` once for
    all levels on the current stream, into one allocation for every map,
    and the launch adds one to its counter (`ops/launches.py`); anything the kernel does not take raises,
    and a kernel that fails to build or launch raises;
  - on CPU tensors it returns `corner_maps_levels_plain`, the same maps from
    the whole-image tensor forms of `ops/fast.py`.

`corner_maps(img, threshold)` is the one-level case of the same kernel;
`corner_score_nms` and `detect` are the reference's entry points on it.

The kernel is compiled at first use with `nvcc` for `sm_90a` into a shared
library with a plain C interface, under `_build/` beside this package and
keyed by a hash of the source, and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes

import torch

from monocular_slam_tpu_torch.ops import fast, launches
from monocular_slam_tpu_torch.utils import cuda_build

MAX_LEVELS = 8  # K1_MAX_LEVELS in csrc/fast_score.cu

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log


class _LevelTable(ctypes.Structure):
    """`K1LevelTable` of csrc/fast_score.cu."""

    _fields_ = [
        ("img", ctypes.c_void_p * MAX_LEVELS),
        ("nms", ctypes.c_void_p * MAX_LEVELS),
        ("raw", ctypes.c_void_p * MAX_LEVELS),
        ("H", ctypes.c_int * MAX_LEVELS),
        ("W", ctypes.c_int * MAX_LEVELS),
        ("tiles_x", ctypes.c_int * MAX_LEVELS),
        ("tile0", ctypes.c_int * (MAX_LEVELS + 1)),
        ("n_levels", ctypes.c_int),
    ]


def corner_maps_plain(img: torch.Tensor, threshold: float = 20.0):
    """(nms, raw) maps of one level by the plain tensor formulation."""
    return fast.nms3(fast.corner_score(img, threshold)), fast.corner_score_raw(img)


def corner_maps_levels_plain(levels, threshold: float = 20.0):
    """`corner_maps_plain` of every level."""
    return [corner_maps_plain(img, threshold) for img in levels]


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = cuda_build.load("fast_score", BUILD_INFO, "fast_corner_maps_levels", [
            ctypes.POINTER(_LevelTable), ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ])
    return _lib


def corner_maps_levels(levels, threshold: float = 20.0):
    """[(nms_score, raw_score)] of each (H_l, W_l) float32 level. Each nms
    map equals `fast.nms3(fast.corner_score(level, threshold))`; each raw
    map equals `fast.corner_score_raw(level)` at least 3 pixels from that
    level's edge."""
    n = len(levels)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"corner_maps_levels takes 1 to {MAX_LEVELS} levels, got {n}")
    if not levels[0].is_cuda:
        if all(x.device.type == "cpu" for x in levels):
            return corner_maps_levels_plain(levels, threshold)
        raise ValueError(f"corner_maps_levels: unsupported device {levels[0].device}")
    dev = levels[0].get_device()
    for img in levels:
        if (img.get_device() != dev or img.dim() != 2 or img.dtype != torch.float32
                or not img.is_contiguous() or img.numel() == 0):
            raise ValueError(
                f"corner_maps_levels takes non-empty contiguous 2-D float32 tensors on one "
                f"card, got {tuple(img.shape)} {img.dtype} on {img.device} "
                f"contiguous={img.is_contiguous()}"
            )
    if dev != torch.cuda.current_device():
        raise ValueError(f"corner_maps_levels: cuda:{dev} is not the current device "
                         f"cuda:{torch.cuda.current_device()}")
    lib = load()
    # one allocation: (nms, raw) of level 0, then of level 1, ...; the views
    # come from one call
    buf = torch.empty(2 * sum(img.numel() for img in levels), dtype=torch.float32,
                      device=levels[0].device)
    maps = torch._utils._unflatten_dense_tensors(buf, [img for img in levels for _ in (0, 1)])
    table = _LevelTable(n_levels=n)
    table.img[:n] = [img.data_ptr() for img in levels]
    table.nms[:n] = [m.data_ptr() for m in maps[0::2]]
    table.raw[:n] = [m.data_ptr() for m in maps[1::2]]
    table.H[:n] = [img.shape[0] for img in levels]
    table.W[:n] = [img.shape[1] for img in levels]
    err = lib.fast_corner_maps_levels(ctypes.byref(table), float(threshold),
                                      launches.pointer("corner_maps", dev),
                                      cuda_build.current_stream())
    if err != 0:
        raise RuntimeError(f"fast_corner_maps_levels launch failed: CUDA error {err}")
    return list(zip(maps[0::2], maps[1::2]))


def corner_maps(img: torch.Tensor, threshold: float = 20.0):
    """(nms_score, raw_score) maps of one (H, W) float32 image: the
    one-level case of `corner_maps_levels`."""
    if img.dim() != 2:
        raise ValueError(f"corner_maps takes a 2-D image, got {tuple(img.shape)}")
    return corner_maps_levels([img], threshold)[0]


def corner_score_nms(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """NMS'd FAST-9 score map of one (H, W) float32 image, by K1 on a card;
    equals `fast.nms3(fast.corner_score(img, threshold))`."""
    return corner_maps(img, threshold)[0]


def detect(img: torch.Tensor, max_corners: int, threshold: float = 20.0) -> fast.Corners:
    """`fast.detect` on K1's score map."""
    return fast.top_corners(corner_score_nms(img, threshold), max_corners)
