"""K2: fused Hamming distance + top-2 matcher, as a CUDA kernel written for
Hopper (counterpart of `monocular_slam_tpu/ops/pallas/hamming.py`).

`hamming_top2(a, b, b_valid)` returns per query row (best distance,
second-best distance, index of the best) over the valid database rows, for
one database (M, 256) or a batch of them (B, M, 256):

  - on CUDA tensors it launches the kernel in `csrc/hamming_top2.cu` on the
    current stream (`hamming_top2_cuda`), whose launch adds one to its
    counter (`ops/launches.py`); an
    input the kernel does not take raises, and a kernel that fails to build
    or launch raises;
  - on CPU tensors it returns `hamming_top2_plain`, the dense distance
    table of `ops/matching.hamming_matrix` plus min, argmin and the masked
    second min.

`match_kernel` is the Lowe-ratio matcher on top of it, the counterpart of
`match_pallas`: the cross-check is a second launch with the roles swapped
(for a batch, every database row of the batch as one query set).
"""

from __future__ import annotations

import ctypes

import torch

from monocular_slam_tpu_torch.ops import launches
from monocular_slam_tpu_torch.utils import cuda_build

BIG = 1 << 20
DESC = 256
MAX_DB_ROWS = 1 << 22  # the kernel's keys hold the row index in 22 bits
# csrc/hamming_top2.cu's tiles: the grid is (ceil(N / Q_TILE), B, splits)
# and a split holds whole tiles of DB_TILE rows
Q_TILE = 64
DB_TILE = 128
BLOCKS_PER_SM = 3  # resident blocks of the kernel per SM (shared memory bound)

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log
_sm_count: dict = {}  # device index -> multiprocessors
_tickets: dict = {}  # (device index, stream) -> int32 zeros the kernel leaves at zero
_retired: list = []  # outgrown ticket buffers: a captured step may still hold their address


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = cuda_build.load("hamming_top2", BUILD_INFO, "hamming_top2", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ])
    return _lib


def hamming_top2_plain(a_pm1: torch.Tensor, b_pm1: torch.Tensor, b_valid: torch.Tensor):
    """(d1, d2, idx) (..., N) int32 from the dense (..., N, M) table: exact
    float32 products (TF32 off), invalid rows at BIG, first argmin, and the
    min over every other column. `b_pm1` (..., M, 256) and `b_valid`
    (..., M) may carry a leading batch of databases."""
    from monocular_slam_tpu_torch.ops.matching import hamming_matrix

    N, M = a_pm1.shape[0], b_pm1.shape[-2]
    dev = a_pm1.device
    shape = (*b_pm1.shape[:-2], N)
    if M == 0:
        full = torch.full(shape, BIG, dtype=torch.int32, device=dev)
        return full, full.clone(), torch.zeros(shape, dtype=torch.int32, device=dev)
    D = torch.where(b_valid[..., None, :], hamming_matrix(a_pm1, b_pm1), BIG)
    idx = torch.argmin(D, dim=-1)
    d1 = D.gather(-1, idx[..., None])[..., 0]
    cols = torch.arange(M, device=dev)
    d2 = torch.where(cols == idx[..., None], BIG, D).min(dim=-1).values
    return d1, d2, idx.to(torch.int32)


def _check(name: str, t: torch.Tensor, dtype, dims: tuple):
    if not t.is_cuda:
        raise ValueError(f"hamming_top2_cuda: {name} is on {t.device}, not a CUDA device")
    if t.dtype != dtype or t.dim() not in dims or not t.is_contiguous():
        raise ValueError(
            f"hamming_top2_cuda: {name} must be a contiguous {dims}-D {dtype} tensor, "
            f"got {tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )


def splits(N: int, M: int, B: int, n_sm: int) -> int:
    """Database splits of a launch: as many as keep the grid within one wave
    of BLOCKS_PER_SM blocks per SM, whole tiles per split, at least 1."""
    q_tiles = -(-N // Q_TILE)
    db_tiles = -(-M // DB_TILE)
    return max(1, min(db_tiles, BLOCKS_PER_SM * n_sm // (q_tiles * B)))


def _ticket_buffer(dev: int, stream: int, n: int) -> torch.Tensor:
    """The stream's ticket counters. The session's step programs capture
    them on their capture stream: the buffer is made by the capture's
    warm-up run, not inside the capture, and is kept alive after it."""
    key = (dev, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=f"cuda:{dev}")
        _tickets[key] = buf
    return buf


def hamming_top2_cuda(a_pm1: torch.Tensor, b_pm1: torch.Tensor, b_valid: torch.Tensor):
    """The kernel entry: (d1, d2, idx) int32 for CUDA inputs a (N, 256) int8
    and b (M, 256) int8 with b_valid (M,) bool -> (N,) each, or b (B, M,
    256) with b_valid (B, M) -> (B, N) each; all contiguous on the current
    card."""
    _check("a", a_pm1, torch.int8, (2,))
    _check("b", b_pm1, torch.int8, (2, 3))
    _check("b_valid", b_valid, torch.bool, (b_pm1.dim() - 1,))
    batched = b_pm1.dim() == 3
    N = a_pm1.shape[0]
    B, M = (b_pm1.shape[0], b_pm1.shape[1]) if batched else (1, b_pm1.shape[0])
    if (a_pm1.shape[1] != DESC or b_pm1.shape[-1] != DESC
            or tuple(b_valid.shape) != tuple(b_pm1.shape[:-1])):
        raise ValueError(
            f"hamming_top2_cuda: shapes a {tuple(a_pm1.shape)}, b {tuple(b_pm1.shape)}, "
            f"b_valid {tuple(b_valid.shape)}; want (N, 256), ([B,] M, 256), ([B,] M)"
        )
    dev = a_pm1.get_device()
    if b_pm1.get_device() != dev or b_valid.get_device() != dev:
        raise ValueError("hamming_top2_cuda: inputs on different devices")
    if dev != torch.cuda.current_device():
        raise ValueError(f"hamming_top2_cuda: cuda:{dev} is not the current device "
                         f"cuda:{torch.cuda.current_device()}")
    if a_pm1.data_ptr() % 16 or b_pm1.data_ptr() % 16:
        raise ValueError("hamming_top2_cuda: descriptor rows must be 16-byte aligned")
    if N >= 2**31 // DESC or M > MAX_DB_ROWS or B > 65535:
        raise ValueError("hamming_top2_cuda: too many rows")
    shape = (3, B, N) if batched else (3, N)
    if N == 0 or B == 0:
        return torch.empty(shape, dtype=torch.int32, device=a_pm1.device).unbind(0)
    n_sm = _sm_count.get(dev)
    if n_sm is None:
        n_sm = _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    S = splits(N, M, B, n_sm)
    # S x B x N (k1, k2) partial keys when the database is split (8-byte
    # aligned at the start of the allocation), then the outputs
    n_part = 2 * S * B * N if S > 1 else 0
    buf = torch.empty(n_part + 3 * B * N, dtype=torch.int32, device=a_pm1.device)
    d1, d2, idx = buf[n_part:].view(shape).unbind(0)
    stream = cuda_build.current_stream()
    part = tickets = 0
    if S > 1:
        part = buf.data_ptr()
        tickets = _ticket_buffer(dev, stream, B * -(-N // Q_TILE)).data_ptr()
    lib = load()
    err = lib.hamming_top2(
        a_pm1.data_ptr(), b_pm1.data_ptr(), b_valid.data_ptr(), N, M, B, S,
        d1.data_ptr(), d2.data_ptr(), idx.data_ptr(), part, tickets,
        launches.pointer("hamming_top2", dev), stream,
    )
    if err != 0:
        raise RuntimeError(f"hamming_top2 launch failed: CUDA error {err}")
    return d1, d2, idx


def hamming_top2(a_pm1: torch.Tensor, b_pm1: torch.Tensor, b_valid: torch.Tensor):
    """Per query row (best_dist, second_dist, best_idx) of Hamming distances
    between a (N, 256) and b ([B,] M, 256) +-1 int8 descriptor sets; invalid
    B rows are excluded. The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if a_pm1.device.type == "cpu":
        return hamming_top2_plain(a_pm1, b_pm1, b_valid)
    return hamming_top2_cuda(a_pm1, b_pm1, b_valid)


def match_kernel(a_pm1, b_pm1, a_valid, b_valid, ratio: float = 0.85, max_dist: int = 256,
                 cross_check: bool = False):
    """Lowe-ratio matcher on K2; the same `Matches` as the dense route of
    `ops.matching.match`, on every row. `b_pm1` (M, 256) or (B, M, 256).
    The cross-check is a second launch: every database row as a query
    against `a_pm1`, masked by `a_valid`. Rows with ~a_valid get idx 0 and
    dist BIG, as the dense route's masking gives."""
    from monocular_slam_tpu_torch.ops.matching import Matches

    d1, d2, idx = hamming_top2(a_pm1, b_pm1, b_valid)
    idx = torch.where(a_valid, idx, 0)
    d1 = torch.where(a_valid, d1, BIG)
    ok = a_valid & (d1.to(torch.float32) < ratio * d2.to(torch.float32)) & (d1 <= max_dist)
    if cross_check:
        M = b_pm1.shape[-2]
        _, _, ridx = hamming_top2(b_pm1.reshape(-1, DESC), a_pm1, a_valid)
        rows = torch.arange(a_pm1.shape[0], dtype=torch.int32, device=a_pm1.device)
        ok = ok & (torch.gather(ridx.view(*b_pm1.shape[:-2], M), -1, idx.long()) == rows)
    return Matches(idx, d1, ok, ok.sum(-1))
