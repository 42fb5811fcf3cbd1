"""Small-matrix linear algebra (counterpart of `monocular_slam_tpu/utils/linalg.py`).

`nullspace_vector("inv_iter")` keeps the reference's shifted inverse power
iteration for RANSAC hypothesis batches; "eigh" is the exact path, through
K3 (`ops/small_eigh.py`) on a card and `torch.linalg.eigh` on the CPU. The
`_ex` factorizations are used where torch offers them, because their plain
forms check `info` with a host sync on CUDA.
"""

from __future__ import annotations

import torch

from monocular_slam_tpu_torch.ops import small_eigh


def gram(A: torch.Tensor) -> torch.Tensor:
    """Batched A^T A over the row axis (..., r, m) -> (..., m, m), as
    broadcast multiply + sum like the reference's `small_gram`."""
    return (A[..., :, :, None] * A[..., :, None, :]).sum(-3)


def smallest_eigvec_psd(A: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Approximate unit eigenvector of the smallest eigenvalue of a batched
    PSD matrix (..., n, n) by shifted inverse power iteration."""
    n = A.shape[-1]
    diag_mean = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    shift = 1e-6 * diag_mean + 1e-12
    M = A + shift * torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(M)
    # a failed factorization yields NaN, as the reference's cholesky does
    L = torch.where((info == 0)[..., None, None], L, float("nan"))
    Lt = L.transpose(-1, -2)

    x = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    for _ in range(iters):
        y = torch.linalg.solve_triangular(L, x[..., None], upper=False)
        x = torch.linalg.solve_triangular(Lt, y, upper=True)[..., 0]
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)
    return x


def nullspace_vector(A: torch.Tensor, method: str = "eigh", iters: int = 8) -> torch.Tensor:
    """Unit vector minimizing |A x| given the normal matrix A (..., n, n)."""
    if method == "eigh":
        _, V = small_eigh.eigh(A)
        return V[..., :, 0]
    return smallest_eigvec_psd(A, iters=iters)


def polar_orthogonalize(M: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Orthogonal factor of batched 3x3 matrices by Newton's polar iteration
    X <- (X + X^{-T}) / 2 (input det > 0)."""
    nrm = torch.linalg.norm(M, dim=(-2, -1), keepdim=True) / 3.0**0.5
    X = M / torch.clamp(nrm, min=1e-12)
    for _ in range(iters):
        Xinv, _ = torch.linalg.inv_ex(X)
        X = 0.5 * (X + Xinv.transpose(-1, -2))
    return X


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of batched 3x3 matrices."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of batched 3x3 matrices (damped SPD
    blocks in BA; the determinant floor never engages there)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    eps = 1e-30
    det = torch.where(
        det.abs() < eps, torch.where(det < 0, -eps, eps).to(det.dtype), det
    )
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]
