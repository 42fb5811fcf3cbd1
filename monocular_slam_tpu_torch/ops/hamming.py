"""K2: fused Hamming distance + top-2 matcher, as a CUDA kernel written for
Hopper (counterpart of `monocular_slam_tpu/ops/pallas/hamming.py`).

`hamming_top2(a, b, b_valid)` returns per query row (best distance,
second-best distance, index of the best) over the valid database rows:

  - on a CUDA tensor it launches the kernel in `csrc/hamming_top2.cu` on
    the current stream (`hamming_top2_cuda`) and adds one to `LAUNCHES`;
    an input the kernel does not take raises, and a kernel that fails to
    build or launch raises;
  - on a CPU tensor it returns `hamming_top2_plain`, the dense distance
    table of `ops/matching.hamming_matrix` plus min, argmin and the masked
    second min.

`match_kernel` is the Lowe-ratio matcher on top of it, the counterpart of
`match_pallas`: the cross-check is a second launch with the roles swapped.
"""

from __future__ import annotations

import ctypes

import torch

from monocular_slam_tpu_torch.utils import cuda_build

LAUNCHES = 0  # kernel launches by `hamming_top2_cuda` in this process
BIG = 1 << 20
DESC = 256

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = cuda_build.load("hamming_top2", BUILD_INFO, "hamming_top2", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ])
    return _lib


def hamming_top2_plain(a_pm1: torch.Tensor, b_pm1: torch.Tensor, b_valid: torch.Tensor):
    """(d1, d2, idx) (N,) int32 from the dense (N, M) table: exact float32
    products (TF32 off), invalid rows at BIG, first argmin, and the min over
    every other column."""
    from monocular_slam_tpu_torch.ops.matching import hamming_matrix

    N, M = a_pm1.shape[0], b_pm1.shape[0]
    dev = a_pm1.device
    if M == 0:
        full = torch.full((N,), BIG, dtype=torch.int32, device=dev)
        return full, full.clone(), torch.zeros(N, dtype=torch.int32, device=dev)
    D = torch.where(b_valid[None, :], hamming_matrix(a_pm1, b_pm1), BIG)
    idx = torch.argmin(D, dim=1)
    d1 = D.gather(1, idx[:, None])[:, 0]
    cols = torch.arange(M, device=dev)
    d2 = torch.where(cols[None, :] == idx[:, None], BIG, D).min(dim=1).values
    return d1, d2, idx.to(torch.int32)


def _check(name: str, t: torch.Tensor, dtype, dims: int):
    if t.device.type != "cuda":
        raise ValueError(f"hamming_top2_cuda: {name} is on {t.device}, not a CUDA device")
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
        raise ValueError(
            f"hamming_top2_cuda: {name} must be a contiguous {dims}-D {dtype} tensor, "
            f"got {tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )


def hamming_top2_cuda(a_pm1: torch.Tensor, b_pm1: torch.Tensor, b_valid: torch.Tensor):
    """The kernel entry: (d1, d2, idx) (N,) int32 for CUDA inputs a (N, 256)
    int8, b (M, 256) int8, b_valid (M,) bool, all contiguous on one card."""
    global LAUNCHES
    _check("a", a_pm1, torch.int8, 2)
    _check("b", b_pm1, torch.int8, 2)
    _check("b_valid", b_valid, torch.bool, 1)
    N, M = a_pm1.shape[0], b_pm1.shape[0]
    if a_pm1.shape[1] != DESC or b_pm1.shape[1] != DESC or b_valid.shape[0] != M:
        raise ValueError(
            f"hamming_top2_cuda: shapes a {tuple(a_pm1.shape)}, b {tuple(b_pm1.shape)}, "
            f"b_valid {tuple(b_valid.shape)}; want (N, 256), (M, 256), (M,)"
        )
    if len({a_pm1.device, b_pm1.device, b_valid.device}) != 1:
        raise ValueError("hamming_top2_cuda: inputs on different devices")
    if a_pm1.data_ptr() % 16 or b_pm1.data_ptr() % 16:
        raise ValueError("hamming_top2_cuda: descriptor rows must be 16-byte aligned")
    if N >= 2**31 // DESC or M >= 2**31 // DESC:
        raise ValueError("hamming_top2_cuda: too many rows")
    out = torch.empty((3, N), dtype=torch.int32, device=a_pm1.device)
    if N == 0:
        return out[0], out[1], out[2]
    lib = load()
    with torch.cuda.device(a_pm1.device):
        err = lib.hamming_top2(
            a_pm1.data_ptr(), b_pm1.data_ptr(), b_valid.data_ptr(), N, M,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            cuda_build.stream_of(a_pm1),
        )
    if err != 0:
        raise RuntimeError(f"hamming_top2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out[0], out[1], out[2]


def hamming_top2(a_pm1: torch.Tensor, b_pm1: torch.Tensor, b_valid: torch.Tensor):
    """Per query row (best_dist, second_dist, best_idx) of Hamming distances
    between a (N, 256) and b (M, 256) +-1 int8 descriptor sets; invalid B
    rows are excluded. The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if a_pm1.device.type == "cpu":
        return hamming_top2_plain(a_pm1, b_pm1, b_valid)
    return hamming_top2_cuda(a_pm1, b_pm1, b_valid)


def match_kernel(a_pm1, b_pm1, a_valid, b_valid, ratio: float = 0.85, max_dist: int = 256,
                 cross_check: bool = False):
    """Lowe-ratio matcher on K2; the same `Matches` as `ops.matching.match`.
    The cross-check runs K2 again with the roles swapped and the query
    validity as the database mask (invalid B rows are not masked as queries
    there, as in the reference), so compare with the dense route only where
    `ok`."""
    from monocular_slam_tpu_torch.ops.matching import Matches

    d1, d2, idx = hamming_top2(a_pm1, b_pm1, b_valid)
    ok = a_valid & (d1.to(torch.float32) < ratio * d2.to(torch.float32)) & (d1 <= max_dist)
    if cross_check:
        _, _, ridx = hamming_top2(b_pm1, a_pm1, a_valid)
        rows = torch.arange(a_pm1.shape[0], dtype=torch.int32, device=a_pm1.device)
        ok = ok & (ridx[idx.long()] == rows)
    return Matches(idx, d1, ok, ok.sum())
