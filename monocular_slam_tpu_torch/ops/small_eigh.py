"""K3: eigen-decomposition of small symmetric matrices and the 3x3 SVD, as
CUDA kernels written for Hopper (`csrc/small_eigh.cu`). No Pallas kernel
stands behind it: the reference's `eigh` and `svd` run inside its compiled
step (XLA's own Jacobi `eigh` on the TPU).

torch's `linalg.eigh` and `linalg.svd` check their status on the host, so
they cannot run inside the CUDA graph of the session's step. The step's
decompositions come here instead:

  - `eigh(A)`: (..., n, n) symmetric, 1 <= n <= 12 (its lower triangle is
    read) -> eigenvalues (..., n) ascending and eigenvectors (..., n, n) as
    columns, each with its largest-magnitude entry positive. The kernel is
    a Jacobi method in double with the round-robin ordering of
    `jacobi_rounds`: a warp per matrix for n = 5..12, a thread per matrix
    for n <= 4;
  - `svd3(M)`: (..., 3, 3) -> U, S (descending), Vt with M = U diag(S) Vt,
    by Jacobi on M^T M in double; `svdvals3(M)` its S.

On CUDA tensors each launches its kernel on the current stream, and the
launch adds one to its counter (`small_eigh` or `svd3` in
`ops/launches.py`); an input the kernel does not take raises, and a kernel
that fails to build or launch raises. On CPU tensors they return
`eigh_plain` / `svd3_plain`, which are `torch.linalg.eigh` and
`torch.linalg.svd` (an eigenvector's sign, and a repeated eigenvalue's
basis, may differ from the kernel's), `eigh` with NaN for a matrix that
holds a non-finite entry, where the CPU routine would raise.
"""

from __future__ import annotations

import ctypes

import torch

from monocular_slam_tpu_torch.ops import launches
from monocular_slam_tpu_torch.utils import cuda_build

MAX_N = 12

_lib = None
BUILD_INFO: dict = {}  # filled by `load()`: path, seconds, log


def load():
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib = cuda_build.load("small_eigh", BUILD_INFO, "small_eigh", [vp, vp, vp, i, i, i, vp, vp])
        lib.svd3.argtypes = [vp, vp, vp, vp, i, i, vp, vp]
        lib.svd3.restype = ctypes.c_int
        _lib = lib
    return _lib


def jacobi_rounds(n: int) -> list[list[tuple[int, int]]]:
    """The kernel's Jacobi schedule for an n x n matrix, as a Python mirror
    of `Slot` in `csrc/small_eigh.cu` (for the tests; nothing calls it on
    the main path): one sweep's rounds, each a list of disjoint pairs
    (p, q), p < q. n is padded to even m with a phantom index m - 1 when
    it is odd; round r pairs r with m - 1 and (r + k) mod (m - 1) with
    (r - k) mod (m - 1) for k = 1 .. m/2 - 1. Pairs with the phantom are
    left out."""
    m = n + (n & 1)
    rounds = []
    for r in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
            if max(a, b) < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return rounds


def eigh_plain(A: torch.Tensor):
    return torch.linalg.eigh(A)


def _eigh_cpu(A: torch.Tensor):
    """`eigh_plain`, with XLA's answer for a matrix holding a non-finite
    entry: NaN values and vectors (torch's CPU routine raises on it, e.g.
    when a failed PnP pose reaches the triangulation)."""
    bad = ~torch.isfinite(A).flatten(-2).all(-1)[..., None]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, V = eigh_plain(torch.where(bad[..., None], eye, A))
    return torch.where(bad, torch.nan, w), torch.where(bad[..., None], torch.nan, V)


def svd3_plain(M: torch.Tensor):
    return torch.linalg.svd(M)


def _prepare(name: str, x: torch.Tensor, n: int) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != x.shape[-2] or not 1 <= x.shape[-1] <= n:
        raise ValueError(f"{name} takes (..., n, n) with 1 <= n <= {n}, got {tuple(x.shape)}")
    if x.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name}: {x.device} is not the current device "
                         f"cuda:{torch.cuda.current_device()}")
    return x.contiguous()


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def eigh(A: torch.Tensor):
    """(eigenvalues, eigenvectors) of symmetric (..., n, n): the kernel on a
    CUDA tensor, `torch.linalg.eigh` on a CPU tensor (NaN for a matrix
    with a non-finite entry)."""
    if A.device.type == "cpu":
        return _eigh_cpu(A)
    if not A.is_cuda:
        raise ValueError(f"small_eigh.eigh: unsupported device {A.device}")
    A = _prepare("small_eigh.eigh", A, MAX_N)
    n = A.shape[-1]
    batch = A.numel() // (n * n)
    w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    if batch == 0:
        return w, V
    if batch >= 2**31:
        raise ValueError("small_eigh.eigh: too many matrices")
    err = load().small_eigh(A.data_ptr(), w.data_ptr(), V.data_ptr(), batch, n,
                            int(A.dtype == torch.float64), launches.pointer("small_eigh", A.device),
                            cuda_build.current_stream())
    _check(err, "small_eigh")
    return w, V


def svdvals3(M: torch.Tensor) -> torch.Tensor:
    """Singular values (..., 3) of (..., 3, 3), descending: `svd3`'s on a
    CUDA tensor, `torch.linalg.svdvals` on a CPU tensor."""
    if M.device.type == "cpu":
        return torch.linalg.svdvals(M)
    return svd3(M)[1]


def svd3(M: torch.Tensor):
    """(U, S, Vt) of (..., 3, 3): the kernel on a CUDA tensor,
    `torch.linalg.svd` on a CPU tensor. The kernel works on M^T M, which
    squares the condition: near a rank deficiency S and U S Vt are good to
    about 1e-8 of the largest singular value, below float32's rounding but
    far above float64's, for float64 inputs too."""
    if M.device.type == "cpu":
        return svd3_plain(M)
    if not M.is_cuda:
        raise ValueError(f"small_eigh.svd3: unsupported device {M.device}")
    if M.shape[-2:] != (3, 3):
        raise ValueError(f"small_eigh.svd3 takes (..., 3, 3), got {tuple(M.shape)}")
    M = _prepare("small_eigh.svd3", M, 3)
    batch = M.numel() // 9
    U = torch.empty_like(M)
    S = torch.empty(M.shape[:-1], dtype=M.dtype, device=M.device)
    Vt = torch.empty_like(M)
    if batch == 0:
        return U, S, Vt
    if batch >= 2**31:
        raise ValueError("small_eigh.svd3: too many matrices")
    err = load().svd3(M.data_ptr(), U.data_ptr(), S.data_ptr(), Vt.data_ptr(), batch,
                      int(M.dtype == torch.float64), launches.pointer("svd3", M.device),
                      cuda_build.current_stream())
    _check(err, "svd3")
    return U, S, Vt
