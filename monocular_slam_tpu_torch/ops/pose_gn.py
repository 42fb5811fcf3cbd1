"""Motion-only BA's Gauss-Newton route as one CUDA kernel written for
Hopper (`csrc/pose_gn.cu`). No Pallas kernel stands behind it: it is the
`solver="gn"` route of `optim/pose_ba.refine_pose`, which XLA fuses into
the reference's compiled step on the TPU and which runs as ~1,700 device
operations a call of 3 rounds op by op.

`refine_pose(T0, X, uv, k, weights, ...)` takes a batch of poses, each
against its own N <= MAX_N edges: T0 (..., 3, 4), X (..., N, 3), uv (...,
N, 2), weights (..., N), all float32, contiguous and with the same leading
dims; k (4,) shared or (..., 4). It returns `PoseBAResult`'s fields (T
(..., 3, 4) float32, inliers (..., N) bool, chi2 (...,) float32, n_inliers
(...,) int64) from one launch on the current stream, which adds one to the
`pose_gn` counter of `ops/launches.py`. It allocates its outputs with
`torch.empty` and synchronizes nothing, so it can be captured into a CUDA
graph. An input it does not take raises `ValueError` before anything
runs, CPU tensors included; a kernel that fails to build or launch raises
`RuntimeError`. `optim/pose_ba.refine_pose` routes every `solver="gn"`
call on CUDA tensors here; CPU tensors take its plain route.
"""

from __future__ import annotations

import ctypes

import torch

from monocular_slam_tpu_torch.ops import launches
from monocular_slam_tpu_torch.utils import cuda_build

MAX_N = 4096  # edges a pose: 1024 threads, 4 edges each in registers

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        vp, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
        _lib = cuda_build.load("pose_gn", BUILD_INFO, "pose_gn",
                               [vp, vp, vp, vp, vp, i, i, i, i, i, f, d, i, d, vp, vp, vp, vp,
                                vp, vp])
    return _lib


def check_inputs(T0, X, uv, k, weights) -> tuple[int, int]:
    """(batch, N) of a call the kernel takes; raises ValueError otherwise."""
    ts = {"T0": T0, "X": X, "uv": uv, "k": k, "weights": weights}
    for name, t in ts.items():
        if t.dtype != torch.float32:
            raise ValueError(f"pose_gn: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pose_gn: {name} must be contiguous")
    if T0.dim() < 2 or T0.shape[-2:] != (3, 4):
        raise ValueError(f"pose_gn: T0 must be (..., 3, 4), got {tuple(T0.shape)}")
    lead = T0.shape[:-2]
    n = X.shape[-2] if X.dim() >= 2 else -1
    for name, t, tail in (("X", X, (n, 3)), ("uv", uv, (n, 2)), ("weights", weights, (n,))):
        if t.shape != lead + tail:
            raise ValueError(f"pose_gn: {name} must be {tuple(lead + tail)} for T0 "
                             f"{tuple(T0.shape)}, got {tuple(t.shape)}")
    if n < 0 or n > MAX_N:
        raise ValueError(f"pose_gn takes 0 <= N <= {MAX_N} edges a pose, got X "
                         f"{tuple(X.shape)}")
    if k.shape not in ((4,), lead + (4,)):
        raise ValueError(f"pose_gn: k must be (4,) or {tuple(lead + (4,))}, got {tuple(k.shape)}")
    devices = {t.device for t in ts.values()}
    if len(devices) != 1 or not T0.is_cuda:
        raise ValueError(f"pose_gn takes CUDA tensors on one device, got {sorted(map(str, devices))}")
    if T0.get_device() != torch.cuda.current_device():
        raise ValueError(f"pose_gn: {T0.device} is not the current device "
                         f"cuda:{torch.cuda.current_device()}")
    return T0.numel() // 12, n


def refine_pose(T0, X, uv, k, weights, n_iters: int, n_rounds: int, chi2_gate: float, tau: float,
                min_points: int, huber_delta: float):
    """(T, inliers, chi2, n_inliers) of `optim/pose_ba.refine_pose(...,
    solver="gn")` with the same options, from one launch."""
    batch, n = check_inputs(T0, X, uv, k, weights)
    if n_iters < 0 or n_rounds < 0:
        raise ValueError(f"pose_gn: n_iters {n_iters} and n_rounds {n_rounds} must be >= 0")
    lead = T0.shape[:-2]
    T = torch.empty_like(T0)
    inl = torch.empty(lead + (n,), dtype=torch.bool, device=T0.device)
    chi2 = torch.empty(lead, dtype=torch.float32, device=T0.device)
    n_inl = torch.empty(lead, dtype=torch.int64, device=T0.device)
    if batch == 0:
        return T, inl, chi2, n_inl
    if batch >= 2**31:
        raise ValueError("pose_gn: too many poses")
    err = load().pose_gn(
        T0.data_ptr(), X.data_ptr(), uv.data_ptr(), weights.data_ptr(), k.data_ptr(),
        0 if k.dim() == 1 else 4, batch, n, n_rounds, n_iters, chi2_gate, tau, min_points,
        huber_delta, T.data_ptr(), inl.data_ptr(), chi2.data_ptr(), n_inl.data_ptr(),
        launches.pointer("pose_gn", T0.device), cuda_build.current_stream())
    if err != 0:
        raise RuntimeError(f"pose_gn launch failed: CUDA error {err}")
    return T, inl, chi2, n_inl
